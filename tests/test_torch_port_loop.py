"""The CLI's optimizer, step and epoch loop against the JAX package's:
SGD against the optax chain over 3 updates, a step with 2 accumulated
microbatches against ``make_train_step(accum_steps=2)``, and
``train_one_epoch`` against the JAX ``train_one_epoch`` over 3 batches.

The toy model of tests/test_torch_port_train.py (64 px, depths
[2, 2, 2, 2], embed 24, window 4, fp32) on numpy weights bridged into the
port (``ckpt.convert.from_jax_variables``), with LayerNorm outside the
GEMMs, dropout and drop-path off. The JAX model is ``build_mtl_model``'s
as the JAX CLI runs it on a CPU host (plain ``jnp``, no Pallas kernel).
SGD keeps the parameter change a linear function of the gradient, so the
updates compare at a relative bound, not at Adam's sign-of-noise bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu.train import optim as joptim
from mtlora_tpu.train.loop import train_one_epoch as jax_train_one_epoch
from mtlora_tpu.train.step import TrainState, make_train_step
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.train import optim
from mtlora_tpu_torch.train.loop import train_one_epoch
from mtlora_tpu_torch.train.step import apply_update, train_step

torch.set_num_threads(2)
CFG = ("configs/mtlora/tiny_448/mtlora_tiny_448_r64_scale4_pertask.yaml")
TASKS = ["semseg", "normals", "sal", "human_parts"]
TOY = ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]", "MODEL.SWIN.EMBED_DIM", "24",
       "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]", "MODEL.SWIN.WINDOW_SIZE", "4",
       "AMP_ENABLE", "False",
       "TPU.USE_PALLAS_LN", "False", "TPU.USE_PALLAS_ADAPTER", "False",
       "MODEL.MTLORA.DROPOUT", "[0.0, 0.0, 0.0, 0.0]",
       "MODEL.DROP_PATH_RATE", "0.0"]
# SGD with Nesterov momentum at a sizeable LR from the first update
# (0.2 * 4 * 2 / 512 = 3.125e-3 with 2 accumulated microbatches of 2)
SGD = ["TRAIN.OPTIMIZER.NAME", "sgd", "TRAIN.BASE_LR", "0.2",
       "TRAIN.WARMUP_EPOCHS", "0", "DATA.BATCH_SIZE", "4",
       "TRAIN.ACCUMULATION_STEPS", "2", "PRINT_FREQ", "2"]
ITERS = 6


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    """The config, the JAX model, numpy weights for it, and 4 batches of 4
    rows (one for the step, three for the epoch)."""
    import os
    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = load_config(os.path.join(root, CFG), tasks=TASKS, img_size=64,
                      opts=TOY + SGD)
    # its kernels in interpret mode, as tests/test_torch_port_train.py
    # runs the JAX step: the attention and head kernels' fp32 order of
    # summation, which the port's plain versions follow
    jmodel = jax_build(cfg).clone(use_pallas=True, use_pallas_ln=False,
                                  use_pallas_adapter=False)
    r = np.random.RandomState(0)
    B, S = 4, 64

    def batch():
        ign = r.rand(B, S, S, 1) < 0.1
        return {
            "image": r.randn(B, S, S, 3).astype(np.float32),
            "semseg": np.where(ign, 255, r.randint(0, 21, (B, S, S, 1)))
            .astype(np.float32),
            "normals": np.where(ign, 255.0, r.uniform(-1, 1, (B, S, S, 3)))
            .astype(np.float32),
            "sal": (r.rand(B, S, S, 1) > 0.5).astype(np.float32),
            "human_parts": np.where(ign, 255, r.randint(0, 7, (B, S, S, 1)))
            .astype(np.float32),
        }

    batches = [batch() for _ in range(4)]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                batches[0]["image"]))
    vr = np.random.RandomState(1)

    def fill(path, s):
        # norm scales near 1 and every LoRA B nonzero, as in a trained
        # model (tests/test_torch_port_train.py:make_parity)
        name = path[-1].key
        if name == "var":
            return vr.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "mean":
            return vr.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        if name == "scale":
            return vr.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return vr.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return cfg, jmodel, variables, batches


def _port(cfg, variables):
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    port.load_state_dict(from_jax_variables(variables, TASKS), strict=True)
    tcfg = optim.train_from_config(cfg)
    return port, tcfg, optim.build_optimizer(port, tcfg), \
        optim.build_schedule(tcfg, ITERS)


def _close_change(port_before, port_after, j_before, j_after, rel):
    """Every tensor's change within ``rel`` of its largest JAX change, or
    4 fp32 ulps of its largest weight (a change read as the difference of
    two fp32 weights carries their rounding); frozen ones (no change in
    JAX) bit-unchanged in the port."""
    moved = 0
    for k, jb in j_before.items():
        dj = _np(j_after[k]) - _np(jb)
        dp = _np(port_after[k]) - _np(port_before[k])
        if not dj.any():
            assert not dp.any(), k
            continue
        moved += 1
        ulps = 4 * 2.0 ** -23 * np.abs(_np(jb)).max()
        np.testing.assert_allclose(
            dp, dj, rtol=0, atol=max(rel * np.abs(dj).max(), ulps),
            err_msg=k)
    assert moved > 0


def test_sgd_matches_optax_chain(setup):
    """``build_optimizer`` with ``TRAIN.OPTIMIZER.NAME sgd`` against the
    JAX package's chain (clip, ``add_decayed_weights`` on the decay mask,
    ``sgd(momentum 0.9, nesterov)``, frozen weights ``set_to_zero``) fed
    the same gradients for 3 updates, the first below the clip norm and
    the others above it: every parameter within 1e-5 of its largest
    change (fp32 sums in another order)."""
    cfg, _, variables, _ = setup
    params = variables["params"]
    tx = joptim.build_optimizer(cfg, params, n_iter_per_epoch=ITERS)
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        upd, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, upd), opt_state,
                optax.global_norm(grads))

    port, tcfg, opt, sched = _port(cfg, variables)
    assert isinstance(opt, torch.optim.SGD)
    assert opt.defaults["nesterov"] and opt.defaults["momentum"] == 0.9
    before = {k: v.clone() for k, v in port.state_dict().items()}
    gr = np.random.RandomState(5)
    jparams = params
    norms = []
    for scale in (1e-4, 1e-2, 3e-2):
        grads = jax.tree.map(
            lambda p: (scale * gr.randn(*p.shape)).astype(np.float32),
            jparams)
        jparams, opt_state, norm = update(grads, opt_state, jparams)
        norms.append(float(norm))
        conv = from_jax_variables({"params": grads}, TASKS)
        for name, p in port.named_parameters():
            p.grad = conv[name].clone() if p.requires_grad else None
        apply_update(opt, sched, tcfg.clip_grad)
    assert norms[0] < tcfg.clip_grad < norms[1]
    assert opt.param_groups[0]["updates"] == 3
    want = from_jax_variables({"params": jax.device_get(jparams)}, TASKS)
    _close_change(before, port.state_dict(),
                  from_jax_variables({"params": params}, TASKS), want, 1e-5)


@pytest.fixture(scope="module")
def jstep(setup):
    """The JAX step with 2 accumulated microbatches, jitted once."""
    cfg, jmodel, variables, _ = setup
    tx = joptim.build_optimizer(cfg, variables["params"],
                                n_iter_per_epoch=ITERS)
    step = jax.jit(make_train_step(jmodel, tx, TASKS, accum_steps=2))

    def fresh():
        return TrainState.create(params=variables["params"], tx=tx,
                                 batch_stats=variables["batch_stats"],
                                 rng=jax.random.PRNGKey(0))

    return step, fresh


# the expand biases of the heads: their gradient is zero in exact
# arithmetic under batch-statistics BN, round-off in both packages
EXPAND_BIASES = {f"decoders.{t}.last_layer.0.bias" for t in TASKS}


def test_accumulation_step_matches_jax(setup, jstep):
    """One step over 4 rows as 2 microbatches of 2 (each its own BN batch
    statistics, the running statistics threaded, the gradients averaged,
    clipped and applied once) against ``make_train_step(accum_steps=2)``:
    loss, task losses and grad norm 1e-4 relative; the heads' running
    statistics 1e-5; and the update's gradient, read back from SGD's
    momentum buffer (after one update, the clipped gradient plus the
    weight decay in both packages), tensor by tensor at the bounds of
    tests/test_torch_port_train.py:test_step_gradients_match_jax: relative
    L2 and largest error within 1e-4 (measured <= 4.4e-5), the normals
    task's downsampler and head 2e-3 (measured 1.3e-4), the expand biases
    below 1e-6 of the largest element in both (round-off, measured
    4e-8). A microbatch split the wrong way, or statistics not threaded,
    moves them by far more."""
    cfg, _, variables, batches = setup
    step, fresh = jstep
    state, m = step(fresh(), {k: jnp.asarray(v)
                              for k, v in batches[0].items()})
    port, tcfg, opt, sched = _port(cfg, variables)
    got = train_step(port, opt, sched,
                     {k: torch.from_numpy(v) for k, v in batches[0].items()},
                     None, clip_grad=tcfg.clip_grad, accum_steps=2)
    for k, v in m.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    after = port.state_dict()
    want_stats = from_jax_variables(
        {"batch_stats": jax.device_get(state.batch_stats)}, TASKS)
    for k, v in want_stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == 2, k       # one update a microbatch
            continue
        np.testing.assert_allclose(_np(after[k]), _np(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    trace = optax.tree_utils.tree_get(state.opt_state, "trace")
    want = {k: _np(v) for k, v in from_jax_variables(
        {"params": jax.device_get(trace)}, TASKS).items() if v.numel()}
    got = {n: _np(opt.state[p]["momentum_buffer"])
           for n, p in port.named_parameters() if p in opt.state}
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        if k in EXPAND_BIASES:
            assert np.abs(w).max() < 1e-6 * top, k
            assert np.abs(g).max() < 1e-6 * top, k
            continue
        tol = 2e-3 if ".normals." in k else 1e-4
        rel_l2 = np.linalg.norm(g - w) / np.linalg.norm(w)
        rel_max = np.abs(g - w).max() / np.abs(w).max()
        assert rel_l2 <= tol and rel_max <= tol, (k, rel_l2, rel_max)
    with pytest.raises(ValueError, match="microbatches"):
        train_step(port, opt, sched, {k: torch.from_numpy(v[:3])
                                      for k, v in batches[0].items()},
                   None, accum_steps=2)


class _Batches:
    """A loader of fixed numpy batches: ``len`` and ``iter_epoch``."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def iter_epoch(self, epoch):
        return iter(self.batches)


def test_train_one_epoch_matches_jax(setup, jstep):
    """``train_one_epoch`` over 3 batches (``PRINT_FREQ`` 2: host reads at
    steps 0 and 2) against the JAX ``train_one_epoch`` with the same
    step: the epoch averages of the loss and each task's loss over every
    step, 1e-4 relative; the port's steps, samples and the steps it
    read."""
    cfg, _, variables, batches = setup
    step, fresh = jstep
    loader = _Batches(batches[1:])
    _, want = jax_train_one_epoch(cfg, fresh(), step, loader, 0)
    port, _, opt, sched = _port(cfg, variables)
    got = train_one_epoch(cfg, port, opt, sched, loader, 0, None)
    assert set(want) == {"loss", *TASKS}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["steps"] == 3 and got["samples"] == 12
    assert [idx for idx, _ in got["logged"]] == [0, 2]
    assert opt.param_groups[0]["updates"] == 3


def test_train_one_epoch_logs_and_scores_the_last_batch(setup):
    """``log_fn`` gets the ``train/*`` series at each host read
    (``PRINT_FREQ`` 2 over 3 batches: steps 0 and 2) and, on an
    ``EVAL_TRAINING`` epoch, the epoch's last batch scored in the
    ``train_eval/*`` schema of ``_score_logs``."""
    cfg, _, variables, batches = setup
    cfg = cfg.clone()
    cfg.EVAL_TRAINING = 1
    port, _, opt, sched = _port(cfg, variables)
    logs = []
    train_one_epoch(cfg, port, opt, sched, _Batches(batches[1:]), 0, None,
                    log_fn=logs.append)
    steps = [d["step"] for d in logs if "train/loss" in d]
    assert steps == [0, 2]
    assert {f"train/loss_{t}" for t in TASKS} <= set(logs[0])
    scored = [d for d in logs if "train_eval/epoch" in d]
    assert len(scored) == 1
    assert {"train_eval/tasks/semseg/mIoU", "train_eval/tasks/normals/mean",
            "train_eval/tasks/sal/maxF",
            "train_eval/tasks/human_parts/mIoU"} <= set(scored[0])
    assert port.training


def test_param_counts_match_jax(setup):
    """The counts the CLI logs (``main.py:build_all``): total, LoRA,
    decoder, trainable and extra, as the JAX package's ``count_params``."""
    cfg, _, variables, _ = setup
    port, tcfg, _, _ = _port(cfg, variables)
    assert optim.count_params(port, tcfg) == joptim.count_params(
        variables["params"], cfg)


def test_accumulation_scales_lr_as_jax():
    """The LR scaled by the accumulation steps, and the schedule over the
    epoch's updates (``n_iter_per_epoch // accum``), as the JAX
    package's, for each schedule."""
    import os
    root = os.path.join(os.path.dirname(__file__), "..")
    for name in ("cosine", "linear", "step", "multistep"):
        cfg = load_config(os.path.join(root, CFG), tasks=TASKS, opts=[
            "TRAIN.ACCUMULATION_STEPS", "3", "DATA.BATCH_SIZE", "24",
            "TRAIN.EPOCHS", "30", "TRAIN.WARMUP_EPOCHS", "1",
            "TRAIN.LR_SCHEDULER.NAME", name,
            "TRAIN.LR_SCHEDULER.MULTISTEPS", "[3, 11]"])
        tcfg = optim.train_from_config(cfg)
        np.testing.assert_allclose(optim.scaled_lrs(tcfg, 2),
                                   joptim.scaled_lrs(cfg, 2), rtol=1e-12)
        jsched = joptim.build_schedule(cfg, 100, 2)
        psched = optim.build_schedule(tcfg, 100, 2)
        base = optim.scaled_lrs(tcfg, 2)[0]
        for k in (0, 10, 33, 34, 200, 500, 989, 990, 2000):
            np.testing.assert_allclose(psched(k), float(jsched(k)),
                                       rtol=1e-6, atol=1e-6 * base,
                                       err_msg=f"{name} @ {k}")
