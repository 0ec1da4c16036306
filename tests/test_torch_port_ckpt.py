"""Pretrained load and checkpoints of the port
(``mtlora_tpu_torch/ckpt/torch_convert.py``, ``ckpt/checkpoint.py``)
against the JAX package's ``ckpt/`` at the toy shape of
``tests/test_end_to_end.py:33-41``.

Converter: one ``.pth`` written here goes through the JAX package's
``load_torch_checkpoint`` + ``merge_converted`` onto the JAX init and
through the port's loader onto the same init carried across; every tensor
is equal (resized tables within 1e-6) and so are the loaded, missing and
unexpected tensors. Two files: a backbone-only file in the official
layout at window 7 (169-row tables resized to the toy's 49, and to 9
where stage 3 clamps the window to 2), and a full MTL file of
``to_reference_state_dict`` with per-task ranks below r_max on the
LN-outside route. Checkpoints: a round trip, a run of 3 + 3 steps resumed
from a file bit-identical to 6 uninterrupted steps with dropout and
drop-path on, ``auto_resume_helper`` and ``keep`` as the JAX ones, a file
without the format key loading weights only, and the port's checkpoint
read by the JAX package under strict ``merge_converted``.
"""

import os
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_port_slice as ts
from mtlora_tpu.ckpt import checkpoint as jax_checkpoint
from mtlora_tpu.ckpt import torch_convert as jtc
from mtlora_tpu.config import load_config
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt import checkpoint, torch_convert
from mtlora_tpu_torch.ckpt.convert import (
    _port_entries,
    from_jax_variables,
    to_reference_state_dict,
)
from mtlora_tpu_torch.models.init import init_weights_
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.serve import random_model
from mtlora_tpu_torch.train.optim import (
    TrainConfig,
    build_optimizer,
    build_schedule,
)
from mtlora_tpu_torch.train.step import synthetic_batch, train_step

torch.set_num_threads(2)
# per-task ranks below r_max = 4 (the YAML's) on the LN-outside route
RANK_FLAGS = ["MODEL.MTLORA.R_PER_TASK.semseg", "[2]",
              "MODEL.MTLORA.R_PER_TASK.sal", "[3]"]


def jax_toy(flags):
    """(config, JAX model, JAX init as numpy, the port model on that
    init) at the toy shape."""
    cfg = load_config(ts.CFG, tasks=ts.TASKS, img_size=64,
                      opts=ts.TOY + flags)
    jmodel = jax_build(cfg)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3))))
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    port.load_state_dict(from_jax_variables(variables, ts.TASKS))
    return cfg, jmodel, variables, port


@pytest.fixture(scope="module")
def toy():
    return jax_toy(ts.SLICE_FLAGS)


@pytest.fixture(scope="module")
def toy_ranks():
    return jax_toy(ts.SLICE_FLAGS + RANK_FLAGS)


def jax_lists(variables, converted, capsys):
    """merge_converted onto the JAX init: (merged variables, its printed
    counts, its missing and unexpected variables as the port's units)."""
    capsys.readouterr()
    merged = jtc.merge_converted(variables, converted)
    counts = tuple(int(n) for n in re.findall(
        r"loaded (\d+) tensors; (\d+) missing.*?(\d+) unexpected",
        capsys.readouterr().out)[0])
    flat_init = flax.traverse_util.flatten_dict(variables)
    flat_new = flax.traverse_util.flatten_dict(converted)

    def units(paths, flat):
        # a path is (collection, *module path, leaf)
        return sorted({torch_convert.load_unit(".".join(key))
                       for p in paths
                       for key, _ in _port_entries(p[1:], flat[p], ts.TASKS)
                       if key[-1] != "num_batches_tracked"})

    missing = units([p for p in flat_init if p not in flat_new], flat_init)
    unexpected = units([p for p in flat_new if p not in flat_init],
                       flat_new)
    return merged, counts, missing, unexpected


def assert_same_weights(port, merged):
    want = from_jax_variables(merged, ts.TASKS)
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("relative_position_bias_table"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


def official_file(port_model, path, window=7):
    source = random_model(port_model.cfg, 1, "cpu")
    torch.save({"model": chip_smoke.official_swin_state_dict(
        source, window=window)}, path)


@pytest.mark.parametrize("route", ["pretrained", "window_untargeted"])
def test_official_backbone_file_matches_jax(toy, tmp_path, capsys, route):
    """``--pretrained`` (window target 4 and (64 // 4)^2 patches,
    skip_decoder, non-strict; 169 -> 49 -> 9 rows), and the same file
    with no window target (169 -> 49 and 169 -> 9 directly): the port
    equals the JAX package, and the counts equal what phase 11 of
    ``chip_smoke.py`` expects (``pretrained_expectation``)."""
    cfg, _, variables, port = toy
    path = str(tmp_path / "official.pth")
    official_file(port, path)
    kw = dict(skip_decoder=True)
    if route == "pretrained":
        kw.update(target_window_size=4, target_num_patches=(64 // 4) ** 2)
    conv = jtc.load_torch_checkpoint(path, ts.TASKS, **kw)
    merged, counts, missing, unexpected = jax_lists(variables, conv, capsys)
    model = build_mtl_model(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    if route == "pretrained":
        got = checkpoint.load_pretrained_(model, path)
    else:
        got = torch_convert.load_converted_(
            model, torch_convert.load_torch_checkpoint(path, ts.TASKS, **kw))
    assert (got["loaded"], len(got["missing"]),
            len(got["unexpected"])) == counts
    assert sorted(got["missing"]) == missing
    assert sorted(got["unexpected"]) == unexpected
    want = chip_smoke.pretrained_expectation(model)
    assert {**got, "missing": sorted(got["missing"]),
            "unexpected": sorted(got["unexpected"])} == want
    assert_same_weights(model, merged)
    tables = [t for k, t in model.state_dict().items()
              if k.endswith("relative_position_bias_table")]
    assert {t.shape[0] for t in tables} == {49, 9}


def test_full_mtl_file_with_ranks_below_rmax_matches_jax(
        toy_ranks, tmp_path, capsys):
    """``to_reference_state_dict`` of a port model with per-task ranks 2,
    4, 3, 4 (r_max 4): ``--resume`` of a reference .pth in both packages
    (window target, decoders kept) loads every tensor, the stacks
    zero-padded to r_max, equal to the JAX merge."""
    cfg, _, variables, port = toy_ranks
    assert port.cfg.stages[0].r_tasks == (2, 4, 3, 4)
    source = random_model(port.cfg, 2, "cpu")
    sd = to_reference_state_dict(source)
    assert sd["backbone.layers.0.blocks.1.attn.proj.lora_tasks_A."
              "semseg"].shape[0] == 2
    path = str(tmp_path / "mtl.pth")
    torch.save({"model": sd}, path)
    conv = jtc.load_torch_checkpoint(path, ts.TASKS, target_window_size=4,
                                     skip_decoder=False)
    merged, counts, missing, unexpected = jax_lists(variables, conv, capsys)
    assert counts[1:] == (0, 0) and not missing and not unexpected
    model = build_mtl_model(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    out = checkpoint.resume_from(path, model)
    assert out == {"start_epoch": 0, "max_accuracy": 0.0}
    # stage 3's 9-row tables go 9 -> 49 (the window target) -> 9 in both
    assert_same_weights(model, merged)
    a = model.state_dict()["backbone.layers.0.blocks.1.attn.proj."
                           "lora_tasks_A"]
    assert not bool(a[0, 2:].any()) and not bool(a[2, 3:].any())


def test_skip_decoder_drops_the_same_keys(toy, tmp_path):
    _, _, variables, port = toy
    sd = to_reference_state_dict(random_model(port.cfg, 3, "cpu"))
    for skip in (False, True):
        conv = jtc.convert_torch_state_dict(sd, ts.TASKS, skip_decoder=skip)
        flat = flax.traverse_util.flatten_dict(conv)
        want = sorted({torch_convert.load_unit(".".join(k))
                       for p, v in flat.items()
                       for k, _ in _port_entries(p[1:], np.asarray(v),
                                                 ts.TASKS)
                       if k[-1] != "num_batches_tracked"})
        got = torch_convert.convert_torch_state_dict(sd, ts.TASKS,
                                                     skip_decoder=skip)
        assert sorted({torch_convert.load_unit(k) for k in got}) == want
        assert skip == (not any(k.startswith(("decoders.", "downsampler."))
                                for k in got))


def test_resize_and_head_remap_match_jax():
    """The bicubic resizes (antialiased F.interpolate, Keys a = -0.5)
    against ``jax.image.resize`` within 1e-6 up and down, and the 22K ->
    1K head map against the JAX function and the JAX converter's head
    surgery."""
    r = np.random.RandomState(0)
    for n in (23, 49, 7, 5, 3):
        t = r.randn(169, 3).astype(np.float32)
        np.testing.assert_allclose(
            torch_convert.resize_rel_pos_bias_table(torch.from_numpy(t),
                                                    n * n).numpy(),
            jtc.resize_rel_pos_bias_table(t, n * n), rtol=0, atol=1e-6)
    pe = r.randn(1, 49, 8).astype(np.float32)
    for n in (16, 3):
        np.testing.assert_allclose(
            torch_convert.resize_abs_pos_embed(torch.from_numpy(pe),
                                               n * n).numpy(),
            jtc.resize_abs_pos_embed(pe, n * n), rtol=0, atol=1e-6)
    w = r.randn(21841, 8).astype(np.float32)
    b = r.randn(21841).astype(np.float32)
    pw, pb = torch_convert.remap_22k_to_1k_head(torch.from_numpy(w),
                                                torch.from_numpy(b))
    jw, jb = jtc.remap_22k_to_1k_head(w.T, b, jtc.DEFAULT_MAP22K)
    assert torch.equal(pw, torch.from_numpy(np.ascontiguousarray(jw.T)))
    assert torch.equal(pb, torch.from_numpy(jb))
    sd = {"head.weight": w, "head.bias": b, "norm.weight": b[:8]}
    for nc, want_w in ((1000, jw.T), (5, np.zeros((5, 8), np.float32))):
        j = jtc.convert_torch_state_dict(sd, num_classes=nc)
        p = torch_convert.convert_torch_state_dict(sd, num_classes=nc)
        jk = np.asarray(j["params"]["backbone"]["head"]["kernel"])
        assert torch.equal(p["backbone.head.weight"],
                           torch.from_numpy(np.ascontiguousarray(jk.T)))
        np.testing.assert_array_equal(jk.T, want_w)
    assert "backbone.head.weight" not in \
        torch_convert.convert_torch_state_dict(sd)
    assert torch_convert.strip_backbone_prefix(
        {"backbone.a": 1, "decoders.b": 2}) == {"a": 1}
    assert torch_convert.strip_backbone_prefix({"a": 1}) == {"a": 1}


def test_load_converted_refuses_shape_mismatch_and_strict(toy):
    _, _, _, port = toy
    model = build_mtl_model(port.cfg, device="cpu")
    sd = dict(model.state_dict())
    key = "backbone.layers.0.blocks.0.attn.qkv.linear.weight"
    bad = {**sd, key: torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_convert.load_converted_(model, bad)
    with pytest.raises(ValueError, match="missing"):
        torch_convert.load_converted_(model, {key: sd[key]}, strict=True)
    with pytest.raises(ValueError, match="unexpected"):
        torch_convert.load_converted_(model, {**sd, "extra.w": sd[key]},
                                      strict=True)
    part = {k: v for k, v in sd.items()
            if not k.startswith("downsampler.semseg.")}
    with pytest.raises(ValueError, match="task tensors"):
        torch_convert.load_converted_(model, part)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_pretrained_(model, "no-such-file.pth")


def train_setup(cfg, seed):
    """A model with nonzero LoRA B, its optimizer and a step generator."""
    model = random_model(cfg, seed, "cpu")
    opt = build_optimizer(model, TrainConfig(batch_size=2, warmup_epochs=0))
    return model, opt, torch.Generator().manual_seed(seed)


def steps(model, opt, gen, batch, n):
    sched = build_schedule(TrainConfig(batch_size=2, warmup_epochs=0), 1000)
    return [{k: float(v) for k, v in train_step(
        model, opt, sched, batch, gen).items()} for _ in range(n)]


@pytest.fixture(scope="module")
def flagship_toy():
    """The flagship's adapter route at the toy shape, with its adapter
    dropout 0.05 and drop-path 0.2."""
    cfg = port_config.from_config(load_config(ts.CFG, tasks=ts.TASKS,
                                              img_size=64, opts=ts.TOY))
    assert cfg.use_pallas_adapter and cfg.drop_path_rate == 0.2
    assert cfg.stages[0].dropout == 0.05
    return cfg


def test_round_trip_and_resume_is_bit_identical(flagship_toy, tmp_path):
    """3 steps, save, a fresh model, optimizer and generator from the
    file, 3 more: the losses of steps 4-6, every parameter and buffer,
    the optimizer state, ``updates``, the LR and the generator state equal
    6 uninterrupted steps bit for bit; the file round-trips exactly."""
    cfg = flagship_toy
    batch = synthetic_batch(2, 64, 0, "cpu")
    model, opt, gen = train_setup(cfg, 0)
    resumed = steps(model, opt, gen, batch, 3)
    path = checkpoint.save_checkpoint(str(tmp_path), 2, model, opt, gen,
                                      max_accuracy=0.25)
    assert os.path.basename(path) == "ckpt_epoch_2.pth"
    fresh = build_mtl_model(cfg, device="cpu")
    init_weights_(fresh, torch.Generator().manual_seed(9))
    fresh_opt = build_optimizer(fresh, TrainConfig(batch_size=2,
                                                   warmup_epochs=0))
    fresh_gen = torch.Generator().manual_seed(9)
    info = checkpoint.load_checkpoint(path, fresh, fresh_opt, fresh_gen)
    assert info == {"epoch": 2, "max_accuracy": 0.25}
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v) or \
            k.endswith("num_batches_tracked"), k
    a, b = opt.state_dict(), fresh_opt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(b["state"][i][k], v), (i, k)
    assert torch.equal(gen.get_state(), fresh_gen.get_state())
    resumed += steps(fresh, fresh_opt, fresh_gen, batch, 3)

    model, opt, gen = train_setup(cfg, 0)
    straight = steps(model, opt, gen, batch, 6)
    assert resumed[3:] == straight[3:]
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    assert [g["updates"] for g in fresh_opt.param_groups] == \
        [g["updates"] for g in opt.param_groups] == [6, 6]
    assert [g["lr"] for g in fresh_opt.param_groups] == \
        [g["lr"] for g in opt.param_groups]
    assert torch.equal(fresh_gen.get_state(), gen.get_state())


def test_auto_resume_and_keep_follow_jax(flagship_toy, tmp_path):
    """The mtime-latest checkpoint, None for an empty or absent directory,
    as the JAX helper over its checkpoint directories; ``keep`` leaves the
    highest epochs by number."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    assert checkpoint.auto_resume_helper(str(pdir)) is None
    assert jax_checkpoint.auto_resume_helper(str(jdir)) is None
    jdir.mkdir()
    pdir.mkdir()
    assert checkpoint.auto_resume_helper(str(pdir)) is None
    assert jax_checkpoint.auto_resume_helper(str(jdir)) is None
    model, opt, gen = train_setup(flagship_toy, 0)
    for epoch, mtime in ((0, 100), (1, 300), (10, 200)):
        p = checkpoint.save_checkpoint(str(pdir), epoch, model, opt, gen)
        os.utime(p, (mtime, mtime))
        (jdir / f"ckpt_epoch_{epoch}").mkdir()
        os.utime(jdir / f"ckpt_epoch_{epoch}", (mtime, mtime))
    (pdir / "other.pth").touch()
    assert os.path.basename(checkpoint.auto_resume_helper(str(pdir))) == \
        os.path.basename(jax_checkpoint.auto_resume_helper(str(jdir))) + \
        ".pth" == "ckpt_epoch_1.pth"
    checkpoint.save_checkpoint(str(pdir), 2, model, opt, gen, keep=2)
    assert sorted(os.listdir(pdir)) == ["ckpt_epoch_10.pth",
                                        "ckpt_epoch_2.pth", "other.pth"]


def test_a_file_without_the_format_key_loads_weights_only(
        flagship_toy, tmp_path):
    """``--resume`` of a reference .pth: the weights (strict-equal to the
    source), epoch 0, the optimizer and generator untouched; and
    ``load_checkpoint`` refuses it."""
    source = random_model(flagship_toy, 4, "cpu")
    path = str(tmp_path / "reference.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          to_reference_state_dict(source).items()},
                "epoch": 7}, path)
    model, opt, gen = train_setup(flagship_toy, 0)
    state = gen.get_state()
    out = checkpoint.resume_from(path, model, opt, gen)
    assert out == {"start_epoch": 0, "max_accuracy": 0.0}
    assert not opt.state_dict()["state"]
    assert [g["updates"] for g in opt.param_groups] == [0, 0]
    assert torch.equal(gen.get_state(), state)
    for k, v in source.state_dict().items():
        # stage 3's window-clamped tables go 9 -> 49 -> 9, as under the
        # JAX main's resume (test_full_mtl_file_with_ranks_below_rmax...)
        if not (k.endswith("num_batches_tracked") or v.shape[0] == 9):
            assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        checkpoint.load_checkpoint(path, model)
    port_path = checkpoint.save_checkpoint(str(tmp_path), 4, model, opt, gen)
    out = checkpoint.resume_from(port_path, model, opt, gen)
    assert out == {"start_epoch": 5, "max_accuracy": 0.0}


def test_port_checkpoint_loads_into_jax(tmp_path):
    """The port's checkpoint after a training step, read by the JAX
    package's ``load_torch_checkpoint`` and a strict ``merge_converted``:
    the JAX forward equals the port's (atol = rtol = 1e-4, as
    ``test_multitask_forward_matches_jax``)."""
    _, jmodel, variables, port, x = ts.make_toy(ts.SLICE_FLAGS)
    opt = build_optimizer(port, TrainConfig(batch_size=2, warmup_epochs=0))
    gen = torch.Generator().manual_seed(0)
    steps(port, opt, gen, synthetic_batch(2, 64, 0, "cpu"), 1)
    path = checkpoint.save_checkpoint(str(tmp_path), 0, port, opt, gen)
    conv = jtc.load_torch_checkpoint(path, ts.TASKS)
    zeros = jax.tree.map(np.zeros_like, variables)
    merged = jtc.merge_converted(zeros, conv, strict=True, verbose=False)
    ref = jax.jit(jmodel.apply)(merged, x)
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    for task in ts.TASKS:
        np.testing.assert_allclose(out[task].numpy(), np.asarray(ref[task]),
                                   atol=1e-4, rtol=1e-4, err_msg=task)
