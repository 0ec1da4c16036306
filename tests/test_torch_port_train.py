"""The port's training slice vs the JAX package: losses, schedules, the
trainability and weight-decay masks, clipping, dropout and drop-path, and
the training step itself against ``make_train_step`` over 1 and 3 steps.

Inputs come from numpy seeds. The JAX model is
``build_mtl_model(cfg).clone(use_pallas=True)``, with the config's
``TPU.USE_PALLAS_LN`` and ``TPU.USE_PALLAS_ADAPTER``, at the toy shape of
tests/test_torch_port_slice.py, so its kernels run forward and backward in
interpret mode; parity runs with adapter dropout
and drop-path at 0 (the random streams of the two frameworks differ), and
dropout and drop-path are tested on their own for rates and masks.
"""

import contextlib
import inspect
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.data.task_config import LOSS_WEIGHTS as JAX_LOSS_WEIGHTS
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu.ops import pallas_adapter_mlp
from mtlora_tpu.train import losses as jlosses
from mtlora_tpu.train import optim as joptim
from mtlora_tpu.train.step import TrainState, make_train_step
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.models.lora import inverted_dropout
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.models.swin import drop_path
from mtlora_tpu_torch.train import losses, optim
from mtlora_tpu_torch.train.profile import breakdown
from mtlora_tpu_torch.train.step import train_step

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
TASKS = ["semseg", "normals", "sal", "human_parts"]
SLICE_FLAGS = ["TPU.USE_PALLAS_LN", "False",
               "TPU.USE_PALLAS_ADAPTER", "False"]
TOY = ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
       "MODEL.SWIN.EMBED_DIM", "24",
       "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
       "MODEL.SWIN.WINDOW_SIZE", "4",
       "AMP_ENABLE", "False"]
# parity: no dropout or drop-path; an LR of 1e-4 from the first update
# (BASE_LR 0.0256 * batch 2 / 512, no warmup); Adam's eps at 1e-6 for both
# packages, so that gradients at round-off level (the expand biases', zero
# in exact arithmetic under batch-statistics BN) make updates far below
# lr instead of +-lr with a sign that is noise
PARITY = ["MODEL.MTLORA.DROPOUT", "[0.0, 0.0, 0.0, 0.0]",
          "MODEL.DROP_PATH_RATE", "0.0",
          "DATA.BATCH_SIZE", "2",
          "TRAIN.BASE_LR", "0.0256",
          "TRAIN.WARMUP_EPOCHS", "0",
          "TRAIN.OPTIMIZER.EPS", "1e-6"]
ITERS = 10


def _np(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0, B=2, S=8):
    r = np.random.RandomState(seed)
    ign = r.rand(B, S, S, 1) < 0.2
    return {
        "semseg": (r.randn(B, S, S, 21).astype(np.float32),
                   np.where(ign, 255, r.randint(0, 21, (B, S, S, 1)))
                   .astype(np.float32)),
        "human_parts": (r.randn(B, S, S, 7).astype(np.float32),
                        np.where(ign, 255, r.randint(0, 7, (B, S, S, 1)))
                        .astype(np.float32)),
        "normals": (r.randn(B, S, S, 3).astype(np.float32),
                    np.where(ign, 255.0, r.uniform(-1, 1, (B, S, S, 3)))
                    .astype(np.float32)),
        "sal": (r.randn(B, S, S, 1).astype(np.float32),
                (r.rand(B, S, S, 1) > 0.5).astype(np.float32)),
        "edge": (r.randn(B, S, S, 1).astype(np.float32),
                 (r.rand(B, S, S, 1) > 0.9).astype(np.float32)),
        "depth": (r.randn(B, S, S, 1).astype(np.float32),
                  np.where(ign, 255.0, r.uniform(0, 5, (B, S, S, 1)))
                  .astype(np.float32)),
    }


def _close_loss_and_grad(fn_jax, fn_port, pred, label):
    val, grad = jax.value_and_grad(fn_jax)(jnp.asarray(pred),
                                           jnp.asarray(label))
    p = torch.from_numpy(pred).requires_grad_()
    out = fn_port(p, torch.from_numpy(label))
    out.backward()
    np.testing.assert_allclose(_np(out), np.asarray(val), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(p.grad), np.asarray(grad), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(grad)).max())


@pytest.mark.parametrize("task", ["semseg", "human_parts", "normals", "sal",
                                  "edge", "depth"])
def test_task_loss_matches_jax(task):
    """Value and gradient of each task's loss, with ignore pixels, 1e-6
    relative."""
    pred, label = _loss_inputs()[task]
    _close_loss_and_grad(jlosses.get_task_loss(task),
                         losses.get_task_loss(task), pred, label)


def test_balanced_bce_row_weight_matches_jax():
    pred, label = _loss_inputs(seed=1)["sal"]
    w = np.array([1.0, 0.0], np.float32)
    _close_loss_and_grad(
        lambda p, l: jlosses.balanced_bce_logits(p, l,
                                                 row_weight=jnp.asarray(w)),
        lambda p, l: losses.balanced_bce_logits(p, l,
                                                row_weight=torch.from_numpy(w)),
        pred, label)


def test_multi_task_loss_matches_jax():
    """The weighted total, each task's loss and the gradient of the total
    for the four PASCAL tasks; the port's weights equal the JAX ones."""
    assert losses.LOSS_WEIGHTS == JAX_LOSS_WEIGHTS
    inp = _loss_inputs(seed=2)
    preds = {t: inp[t][0] for t in TASKS}
    targets = {t: inp[t][1] for t in TASKS}

    def jtotal(ps):
        total, per = jlosses.multi_task_loss(
            ps, {t: jnp.asarray(v) for t, v in targets.items()}, TASKS)
        return total, per

    (total_ref, per_ref), g_ref = jax.value_and_grad(jtotal, has_aux=True)(
        {t: jnp.asarray(v) for t, v in preds.items()})
    tp = {t: torch.from_numpy(v).requires_grad_() for t, v in preds.items()}
    total, per = losses.multi_task_loss(
        tp, {t: torch.from_numpy(v) for t, v in targets.items()}, TASKS)
    total.backward()
    np.testing.assert_allclose(_np(total), np.asarray(total_ref), rtol=1e-6)
    for t in TASKS:
        np.testing.assert_allclose(_np(per[t]), np.asarray(per_ref[t]),
                                   rtol=1e-6, err_msg=t)
        g = np.asarray(g_ref[t])
        np.testing.assert_allclose(_np(tp[t].grad), g, rtol=1e-6,
                                   atol=1e-6 * np.abs(g).max(), err_msg=t)


# ---------------------------------------------------------------------------
# Schedules, masks, clipping
# ---------------------------------------------------------------------------

STEPS = [0, 1, 7, 50, 99, 100, 101, 150, 1234, 2999, 3000, 3500]


@pytest.mark.parametrize("name,opts", [
    ("cosine", []),
    ("cosine", ["TRAIN.LR_SCHEDULER.WARMUP_PREFIX", "False"]),
    ("linear", []),
    ("step", ["TRAIN.LR_SCHEDULER.DECAY_EPOCHS", "7"]),
    ("multistep", ["TRAIN.LR_SCHEDULER.MULTISTEPS", "[3, 11]"]),
])
def test_schedule_matches_jax(name, opts):
    """Each schedule at step points through warmup, decay and the end,
    built from the same config (batch 24, 30 epochs of 100 steps, 1
    warmup epoch): 1e-6 relative, plus 1e-6 of the base LR for the fp32
    cancellation of the JAX formulas near their floor."""
    cfg = load_config(CFG, tasks=TASKS, opts=SLICE_FLAGS + [
        "TRAIN.LR_SCHEDULER.NAME", name, "DATA.BATCH_SIZE", "24",
        "TRAIN.EPOCHS", "30", "TRAIN.WARMUP_EPOCHS", "1"] + opts)
    jsched = joptim.build_schedule(cfg, n_iter_per_epoch=100)
    psched = optim.build_schedule(optim.train_from_config(cfg), 100)
    base = optim.scaled_lrs(optim.train_from_config(cfg))[0]
    for step in STEPS:
        np.testing.assert_allclose(psched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-6 * base,
                                   err_msg=f"{name} @ {step}")


@pytest.fixture(scope="module")
def parity():
    """The JAX and port models on the same numpy weights, and the batch."""
    return make_parity(SLICE_FLAGS)


def make_parity(flags, jax_route=None):
    """:func:`parity` on the route that ``flags`` select: the JAX model
    takes the config's ``TPU.USE_PALLAS_LN`` and ``TPU.USE_PALLAS_ADAPTER``
    (``build_mtl_model`` turns them off on a CPU host), unless
    ``jax_route`` names them, ``(use_pallas_ln, use_pallas_adapter)``."""
    cfg = load_config(CFG, tasks=TASKS, img_size=64,
                      opts=TOY + flags + PARITY)
    ln, adapter = (jax_route if jax_route is not None else
                   (bool(cfg.TPU.USE_PALLAS_LN),
                    bool(cfg.TPU.USE_PALLAS_ADAPTER)))
    jmodel = jax_build(cfg).clone(use_pallas=True, use_pallas_ln=ln,
                                  use_pallas_adapter=adapter)
    r = np.random.RandomState(0)
    B, S = 2, 64
    ign = r.rand(B, S, S, 1) < 0.1
    batch = {
        "image": r.randn(B, S, S, 3).astype(np.float32),
        "semseg": np.where(ign, 255, r.randint(0, 21, (B, S, S, 1)))
        .astype(np.float32),
        "normals": np.where(ign, 255.0, r.uniform(-1, 1, (B, S, S, 3)))
        .astype(np.float32),
        "sal": (r.rand(B, S, S, 1) > 0.5).astype(np.float32),
        "human_parts": np.where(ign, 255, r.randint(0, 7, (B, S, S, 1)))
        .astype(np.float32),
    }
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                batch["image"]))
    vr = np.random.RandomState(1)

    def fill(path, s):
        # norm scales near 1, as in a trained model: with scales near 0
        # the head's input is nearly constant over rows, and the batch
        # variance E[h^2] - E[h]^2 cancels to round-off in both packages
        name = path[-1].key
        if name == "var":
            return vr.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "mean":
            return vr.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        if name == "scale":
            return vr.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return vr.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return cfg, jmodel, variables, batch


def _port_model(cfg, variables):
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    port.load_state_dict(from_jax_variables(variables, TASKS), strict=True)
    return port


def _leaf_masks(params, mask_tree):
    """A JAX mask tree mapped leaf by leaf onto the port's names: every
    leaf becomes an array filled with its mask value, and
    ``from_jax_variables`` carries it to the port key(s)."""
    filled = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32),
                          params, mask_tree)
    out = {}
    for k, v in from_jax_variables({"params": filled}, TASKS).items():
        vals = np.unique(v.numpy())
        assert len(vals) == 1, k
        out[k] = bool(vals[0])
    return out


def test_trainable_and_decay_masks_match_jax(parity):
    cfg, _, variables, _ = parity
    port = _port_model(cfg, variables)
    tcfg = optim.train_from_config(cfg)
    want = _leaf_masks(variables["params"],
                       joptim.lora_trainable_mask(variables["params"], cfg))
    got = optim.lora_trainable_mask(port, tcfg)
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    want = _leaf_masks(variables["params"],
                       joptim.no_weight_decay_mask(variables["params"]))
    assert optim.no_weight_decay_mask(port) == want
    # the frozen linear weights are frozen in the model itself
    for name, p in port.named_parameters():
        assert p.requires_grad == (".linear." not in name), name


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    """Below the limit the gradients pass unchanged; above it each becomes
    (g / |g|) * 5, as ``optax.clip_by_global_norm`` computes."""
    r = np.random.RandomState(3)
    gs = [(scale * r.randn(*s)).astype(np.float32)
          for s in ((7, 5), (11,), (3, 4, 2))]
    ref, _ = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    ts = [torch.from_numpy(g.copy()) for g in gs]
    norm = optim.clip_by_global_norm_(ts, 5.0)
    np.testing.assert_allclose(_np(norm),
                               float(optax.global_norm(gs)), rtol=1e-6)
    for t, g, want in zip(ts, gs, ref):
        if scale < 1:
            np.testing.assert_array_equal(t.numpy(), g)
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_train_preset_equals_yaml_config():
    """The entry point's TrainConfig is the YAML's TRAIN at batch 32."""
    cfg = load_config(CFG, tasks=TASKS,
                      opts=SLICE_FLAGS + ["DATA.BATCH_SIZE", "32"])
    assert optim.train_from_config(cfg) == optim.TrainConfig(batch_size=32)


def test_build_mtl_model_defaults_to_the_card():
    assert (inspect.signature(build_mtl_model).parameters["device"].default
            == "cuda")


def test_accumulation_steps_raise():
    """TRAIN.ACCUMULATION_STEPS > 1 is refused where the LR and schedule
    are built, so no run scales the LR for an accumulation that the step
    does not do."""
    cfg = load_config(CFG, tasks=TASKS, opts=SLICE_FLAGS + [
        "TRAIN.ACCUMULATION_STEPS", "2"])
    tcfg = optim.train_from_config(cfg)
    assert tcfg.accumulation_steps == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.build_schedule(tcfg, ITERS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.scaled_lrs(tcfg)


def test_trace_breakdown_classes_and_idle_share(tmp_path):
    """Kernel time summed by class per step; busy time is the union of the
    kernel intervals, so overlapping kernels count once; host events are
    ignored."""
    import json
    events = [
        {"cat": "kernel", "name": "window_attn_bwd_kernel", "ts": 0,
         "dur": 100},
        {"cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 50,
         "dur": 100},
        {"cat": "kernel", "name": "vectorized_elementwise_kernel",
         "ts": 300, "dur": 100},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1000},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = breakdown(str(path), steps=2)
    assert out["ms_per_step"] == {"window attention kernel (bwd)": 0.05,
                                  "GEMMs (cuBLAS / CUTLASS)": 0.05,
                                  "elementwise": 0.05}
    assert out["busy_ms_per_step"] == pytest.approx(0.125)
    assert out["span_ms_per_step"] == pytest.approx(0.2)
    assert out["idle_share"] == pytest.approx(1 - 250 / 400)


# ---------------------------------------------------------------------------
# Dropout and drop-path
# ---------------------------------------------------------------------------

def test_inverted_dropout_rate_scale_and_seed():
    """Keep rate 1 - p and kept values x / (1 - p) over 400k draws; the
    same seed gives the same mask, another seed another."""
    p = 0.05
    x = torch.full((400, 1000), 3.0)
    y = inverted_dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    # binomial std of the rate: sqrt(p (1 - p) / n) = 3.4e-4; 5 sigma
    assert abs(kept.float().mean().item() - (1 - p)) < 1.7e-3
    np.testing.assert_allclose(y[kept].numpy(), 3.0 / 0.95, rtol=1e-6)
    y2 = inverted_dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    y3 = inverted_dropout(x, p, torch.Generator().manual_seed(1))
    assert not torch.equal(y, y3)
    with pytest.raises(ValueError, match="Generator"):
        inverted_dropout(x, p, None)


def test_dropout_mask_is_shared_by_forward_and_backward():
    x = torch.randn(64, 32, requires_grad=True)
    y = inverted_dropout(x, 0.3, torch.Generator().manual_seed(4))
    y.sum().backward()
    kept = y.detach() != 0
    assert torch.equal(x.grad != 0, kept)
    np.testing.assert_allclose(x.grad[kept].numpy(), 1 / 0.7, rtol=1e-6)


def test_drop_path_per_sample_and_per_task():
    """One coefficient in {0, 1/keep} per sample on [B, L, C] and per
    (task, sample) on [T, B, L, C]; the keep rate over many draws."""
    rate = 0.2
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4, 2000, 3, 5)                 # [T, B, L, C]
    y = drop_path(x, rate, gen)
    coef = y[..., :1, :1]
    assert torch.equal(y, coef.expand_as(y))      # constant within a row
    vals = set(np.unique(coef.numpy()).tolist())
    assert vals <= {0.0, float(np.float32(1 / 0.8))}
    # 8000 draws: std of the rate 4.5e-3; 5 sigma
    assert abs((coef != 0).float().mean().item() - 0.8) < 2.3e-2
    xs = torch.ones(3000, 3, 5)                   # [B, L, C]
    ys = drop_path(xs, rate, torch.Generator().manual_seed(0))
    assert torch.equal(ys, ys[:, :1, :1].expand_as(ys))
    z = drop_path(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(y, z)


def test_model_train_mode_draws_and_eval_does_not():
    """In training, dropout and drop-path change the output and depend on
    the generator's seed; at eval the generator is not used."""
    cfg = load_config(CFG, tasks=TASKS, img_size=64, opts=TOY + SLICE_FLAGS)
    pcfg = port_config.from_config(cfg)
    assert pcfg.stages[0].dropout == 0.05 and pcfg.drop_path_rate == 0.2
    from mtlora_tpu_torch.models.mtl import init_random_
    model = init_random_(build_mtl_model(pcfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.no_grad():
        ev = model(x)["semseg"]
        ev2 = model(x, torch.Generator().manual_seed(9))["semseg"]
        model.train()
        a = model(x, torch.Generator().manual_seed(1))["semseg"]
        b = model(x, torch.Generator().manual_seed(1))["semseg"]
        c = model(x, torch.Generator().manual_seed(2))["semseg"]
    assert torch.equal(ev, ev2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)


# ---------------------------------------------------------------------------
# The training step against make_train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps(parity):
    """Three steps of both steps from the same weights and batch; the JAX
    step is jitted once."""
    return run_steps(parity, 3)


@contextlib.contextmanager
def exact_erf():
    """The JAX package's fp32 Pallas kernels take GELU with an
    Abramowitz-Stegun erf (``pallas_adapter_mlp._erf``, error 1.5e-7, a
    relative error of up to ~3e-6 in GELU where its input is negative);
    the port takes the exact erf (ROADMAP Queue 3). For the step parity,
    while the JAX step is traced, the kernels take ``jax.lax.erf``: the
    comparison then holds the port to the JAX route's algorithm, and the
    ops tests hold it to the kernels as they are."""
    saved = pallas_adapter_mlp._erf
    pallas_adapter_mlp._erf = jax.lax.erf
    try:
        yield
    finally:
        pallas_adapter_mlp._erf = saved


def run_steps(parity, n_steps):
    """``n_steps`` of both training steps from the parity weights."""
    cfg, jmodel, variables, batch = parity
    tx = joptim.build_optimizer(cfg, variables["params"],
                                n_iter_per_epoch=ITERS)
    state = TrainState.create(params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"],
                              rng=jax.random.PRNGKey(0))
    jstep = jax.jit(make_train_step(jmodel, tx, TASKS))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_states, jax_metrics = [state], []
    with exact_erf():
        for _ in range(n_steps):
            state, m = jstep(state, jbatch)
            jax_states.append(state)
            jax_metrics.append({k: float(v) for k, v in m.items()})

    port = _port_model(cfg, variables)
    tcfg = optim.train_from_config(cfg)
    opt = optim.build_optimizer(port, tcfg)
    sched = optim.build_schedule(tcfg, ITERS)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port_states, port_metrics, port_grads = [before], [], []
    for _ in range(n_steps):
        m = train_step(port, opt, sched, tbatch, None,
                       clip_grad=tcfg.clip_grad)
        port_metrics.append({k: float(v) for k, v in m.items()})
        port_states.append({k: v.clone()
                            for k, v in port.state_dict().items()})
        port_grads.append({n: p.grad.clone()
                           for n, p in port.named_parameters()
                           if p.grad is not None})
    return dict(tx=tx, jax_states=jax_states, jax_metrics=jax_metrics,
                port_states=port_states, port_metrics=port_metrics,
                port_grads=port_grads, lr=sched(0))


@pytest.mark.parametrize("n", [1, 3])
def test_step_metrics_match_jax(steps, n):
    """loss, the per-task losses and the pre-clip grad norm of steps 1
    and 3, 1e-4 relative; the grad norm of step 3 at 1e-3: the two runs
    drift apart from the first update on, where Adam maps gradients with
    round-off-sized differences to updates of different size, and the
    norm, dominated by the patch embedding and the merges, amplifies it
    (measured 2e-4)."""
    got, want = steps["port_metrics"][n - 1], steps["jax_metrics"][n - 1]
    assert set(got) == set(want)
    for k in want:
        rtol = 1e-3 if (n == 3 and k == "grad_norm") else 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("n", [1, 3])
def test_step_batch_stats_match_jax(steps, n):
    """The heads' running statistics after 1 and 3 steps, 1e-5 and, with
    the drift of the parameters, 1e-4 (measured 2.5e-5)."""
    want = from_jax_variables(
        {"batch_stats": jax.device_get(steps["jax_states"][n].batch_stats)},
        TASKS)
    got = steps["port_states"][n]
    assert len(want) == 12      # mean, var, count for 4 heads
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == n, k
            continue
        tol = 1e-5 if n == 1 else 1e-4
        np.testing.assert_allclose(_np(got[k]), _np(v), atol=tol, rtol=tol,
                                   err_msg=k)


def _jax_first_grads(steps, params):
    """The clipped gradients of the JAX step's first update, read back
    from Adam's first moment (mu = (1 - b1) g after one update), and 0
    for the frozen leaves."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jax.device_get(steps["jax_states"][1].opt_state),
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    g = jax.tree.map(
        lambda mu, p: (np.zeros(p.shape, np.float32)
                       if isinstance(mu, optax.MaskedNode)
                       else np.asarray(mu) / (1 - 0.9)),
        adam[0].mu, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return from_jax_variables({"params": g}, TASKS)


# the heads' expand biases feed batch-statistics BN, which subtracts the
# batch mean: their gradient is zero in exact arithmetic, and what both
# packages compute there is round-off
EXPAND_BIASES = tuple(f"decoders.{t}.last_layer.0.bias" for t in TASKS)


def test_step_gradients_match_jax(steps):
    """Every trainable gradient of the first step (after clipping), tensor
    by tensor: the relative L2 error and the largest error (relative to
    the tensor's largest element) within 1e-4 (measured <= 6.2e-5), except
      - the normals task's downsampler and head, 2e-3 (measured 1.1e-3):
        its loss is the L1 of the L2-normalised prediction, and a change
        of the input images by 1e-6 relative moves these gradients in
        the port alone by as much as the two packages differ;
      - the four expand biases: below 1e-6 of the largest gradient
        element in both packages (measured 5.7e-8).
    The frozen ones do not exist in the port and are zero in JAX."""
    check_first_grads(steps)


# The saliency head's prediction bias: its gradient sums 8,192 per-pixel
# terms that cancel 86-fold (balanced BCE at an untrained head), and the
# JAX package's own jitted and op-by-op steps give it 1.9e-4 apart on the
# LN route; each package's fp32 value lies up to 5.6e-5 (port) and 1.7e-4
# (JAX) from an fp64 run of the same algorithm (measured at the parity
# weights on all three routes), so two fp32 runs through different kernel
# routes are held to their sum, 2.3e-4, at 3e-4.
KERNEL_ROUTE_ROUNDING = {"decoders.sal.last_layer.3.bias": 3e-4}


def check_first_grads(steps, rounding=None):
    """The body of :func:`test_step_gradients_match_jax`; ``rounding``:
    the bound of named tensors whose fp32 value in either package varies
    by more than 1e-4 (:data:`KERNEL_ROUTE_ROUNDING`)."""
    params = jax.device_get(steps["jax_states"][0].params)
    want = {k: _np(v) for k, v in _jax_first_grads(steps, params).items()}
    got = {k: _np(v) for k, v in steps["port_grads"][0].items()}
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if k not in got:
            assert not w.any(), k
            continue
        g = got[k]
        if k in EXPAND_BIASES:
            assert np.abs(w).max() < 1e-6 * top, k
            assert np.abs(g).max() < 1e-6 * top, k
            continue
        if not w.any():     # the last block's shared stream: no head reads it
            assert not g.any(), k
            continue
        tol = 2e-3 if ".normals." in k else (rounding or {}).get(k, 1e-4)
        rel_l2 = np.linalg.norm(g - w) / np.linalg.norm(w)
        rel_max = np.abs(g - w).max() / np.abs(w).max()
        assert rel_l2 <= tol and rel_max <= tol, (k, rel_l2, rel_max)


@pytest.mark.parametrize("n", [1, 3])
def test_step_updates_match_jax(steps, n):
    """The trainables' change after 1 and 3 updates, against tolerances
    tied to the LR. Adam's first update is about lr * g / (|g| + eps), so
    where |g| is at the round-off of the gradients its size is noise:
      - elements with |g_jax| < 1e-6 of the largest gradient element are
        left out, unless exactly 0 (weight decay alone: the shared-stream
        adapters of the last block, whose output no head reads); at most
        0.2% of the elements may be (0.07% measured);
      - the expand biases (round-off throughout) move by less than
        2e-2 lr per update in both packages (8.2e-3 lr measured).
    Every other element is within lr per update of the JAX change (0.35 lr
    measured; a wrong sign gives 2 lr). At most 5% of the elements of any
    tensor, and at most 1e-3 (1 update) or 5e-3 (3 updates) of all,
    differ by more than 1e-2 lr per update (measured 1.0% and 2.9e-4
    after 1, 2.5% and 2.3e-3 after 3, as the runs drift apart). Frozen
    weights are bit-unchanged."""
    lr = steps["lr"]
    params0 = jax.device_get(steps["jax_states"][0].params)
    paramsn = jax.device_get(steps["jax_states"][n].params)
    j0 = from_jax_variables({"params": params0}, TASKS)
    jn = from_jax_variables({"params": paramsn}, TASKS)
    grads = {k: np.abs(_np(v))
             for k, v in _jax_first_grads(steps, params0).items()}
    top = max(g.max() for g in grads.values())
    p0, pn = steps["port_states"][0], steps["port_states"][n]
    masked = total = over = 0
    for k in j0:
        dj = _np(jn[k]) - _np(j0[k])
        dp = _np(pn[k]) - _np(p0[k])
        if k not in steps["port_grads"][0]:
            assert not dp.any() and not dj.any(), k   # frozen
            continue
        if k in EXPAND_BIASES:
            assert np.abs(dj).max() < 2e-2 * lr * n, k
            assert np.abs(dp).max() < 2e-2 * lr * n, k
            continue
        g = grads[k]
        keep = (g >= 1e-6 * top) | (g == 0)
        masked += int((~keep).sum())
        total += keep.size
        diff = np.abs(dp - dj)[keep]
        assert (diff <= lr * n).all(), k
        n_over = int((diff > 1e-2 * lr * n).sum())
        assert n_over <= 0.05 * diff.size, (k, n_over, diff.size)
        over += n_over
    assert masked <= 2e-3 * total, (masked, total)
    assert over <= (1e-3 if n == 1 else 5e-3) * (total - masked), over
