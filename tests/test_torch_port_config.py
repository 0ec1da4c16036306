"""The port's config tree against the JAX package's: every YAML under
``configs/`` with the four PASCAL and the four NYUD tasks, the ``--opts``
overrides, the CLI flags, the YAML subset's scalars against
``yaml.safe_load``, and the dump read back.

The port reads YAML with its own subset (``utils/yaml_subset.py``); these
tests import ``yaml`` only to hold it to PyYAML.
"""

import glob
import json
import os

import pytest
import yaml

from mtlora_tpu import config as jconfig
from mtlora_tpu_torch import config as pconfig
from mtlora_tpu_torch.main import build_parser
from mtlora_tpu_torch.utils import yaml_subset

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_DIR = os.path.join(ROOT, "configs")
YAMLS = sorted(os.path.relpath(f, CFG_DIR) for f in glob.glob(
    os.path.join(CFG_DIR, "**", "*.yaml"), recursive=True))
FLAGSHIP = os.path.join(CFG_DIR, "mtlora/tiny_448/"
                        "mtlora_tiny_448_r64_scale4_pertask.yaml")
PASCAL = ("PASCALContext", ["semseg", "normals", "sal", "human_parts"])
NYUD = ("NYUD", ["semseg", "normals", "edge", "depth"])


def test_thirteen_yamls():
    assert len(YAMLS) == 13, YAMLS


@pytest.mark.parametrize("db,tasks", [PASCAL, NYUD], ids=["pascal", "nyud"])
@pytest.mark.parametrize("name", YAMLS)
def test_yaml_loads_as_jax(name, db, tasks):
    """``load_config`` of each YAML, its ``BASE`` chain followed, equals
    the JAX package's ``load_config(...).to_dict()``, the per-stage MTLoRA
    lists and the task config included."""
    path = os.path.join(CFG_DIR, name)
    got = pconfig.load_config(path, tasks=tasks, db_name=db)
    want = jconfig.load_config(path, tasks=tasks, db_name=db)
    assert got.to_dict() == want.to_dict()
    assert got.is_frozen()


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_file_reads_as_safe_load(name):
    path = os.path.join(CFG_DIR, name)
    with open(path) as f:
        assert yaml_subset.load(path) == yaml.safe_load(f)


# tests/test_config.py's overrides, and those the repo's tests pass
OPTS = [
    ["TRAIN.BASE_LR", "1e-3", "DATA.BATCH_SIZE", "16",
     "MODEL.MTLORA.ENABLED", "True"],
    ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]", "MODEL.SWIN.EMBED_DIM", "24",
     "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]", "MODEL.SWIN.WINDOW_SIZE", "4",
     "AMP_ENABLE", "False"],
    ["MODEL.MTLORA.DROPOUT", "[0.0, 0.0, 0.0, 0.0]",
     "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.OPTIMIZER.EPS", "1e-6",
     "TRAIN.WARMUP_EPOCHS", "0", "TRAIN.BASE_LR", "0.0256"],
    ["TRAIN.LR_SCHEDULER.NAME", "multistep",
     "TRAIN.LR_SCHEDULER.MULTISTEPS", "[3, 11]",
     "TRAIN.LR_SCHEDULER.DECAY_EPOCHS", "7"],
    ["TPU.USE_PALLAS_LN", "False", "TPU.USE_PALLAS_ADAPTER", "off",
     "TPU.EVAL_DTYPE", "bfloat16", "TPU.MESH_SHAPE", "[-1]"],
    ["MODEL.SWIN.QK_SCALE", "0.125", "AUG.CUTMIX_MINMAX", "[0.2, 0.8]",
     "MODEL.MTLORA.R", "[16]", "TRAIN.AUTO_RESUME", "yes"],
    ["TRAIN.ACCUMULATION_STEPS", "2", "TRAIN.OPTIMIZER.NAME", "sgd",
     "TRAIN.OPTIMIZER.MOMENTUM", "0.8", "SEED", "7", "PRINT_FREQ", "1"],
    ["MODEL.SWIN.QK_SCALE", "~", "TRAIN.CLIP_GRAD", "0.0",
     "MODEL.MTLORA.SCALE_PER_TASK", "{semseg: [2.0]}"],
]


@pytest.mark.parametrize("opts", OPTS, ids=[str(i) for i in range(len(OPTS))])
def test_opts_coerce_as_jax(opts):
    """``merge_from_list`` on the default tree and ``load_config`` of the
    flagship with ``opts``: the same values and types as the JAX
    package's."""
    got, want = pconfig.default_config(), jconfig.default_config()
    got.merge_from_list(opts)
    want.merge_from_list(opts)
    assert got.to_dict() == want.to_dict()
    assert ({k: type(v) for k, v in _flat(got.to_dict()).items()}
            == {k: type(v) for k, v in _flat(want.to_dict()).items()})
    if "SCALE_PER_TASK" in " ".join(opts):
        return      # a per-task scale for one task leaves the others unset
    got = pconfig.load_config(FLAGSHIP, tasks=PASCAL[1], opts=opts)
    want = jconfig.load_config(FLAGSHIP, tasks=PASCAL[1], opts=opts)
    assert got.to_dict() == want.to_dict()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_opts_cases_of_the_jax_tests():
    """tests/test_config.py:test_merge_from_list_coerces_types on the
    port's tree."""
    c = pconfig.default_config()
    c.merge_from_list(["TRAIN.BASE_LR", "1e-3", "DATA.BATCH_SIZE", "16",
                       "MODEL.MTLORA.ENABLED", "True"])
    assert c.TRAIN.BASE_LR == 1e-3
    assert c.DATA.BATCH_SIZE == 16
    assert c.MODEL.MTLORA.ENABLED is True


def test_confignode_freeze_and_clone():
    c = pconfig.ConfigNode({"A": 1, "B": {"C": [1, 2]}})
    assert c.A == 1 and c.B.C == [1, 2]
    c.freeze()
    with pytest.raises(AttributeError):
        c.A = 2
    with pytest.raises(AttributeError):
        c.B.C = 3
    c2 = c.clone()
    c2.A = 3
    assert c.A == 1 and c2.A == 3


CLI_ARGS = [
    ["--tasks", "semseg,normals,sal,human_parts", "--synthetic-data"],
    ["--tasks", "semseg, normals ,edge,depth", "--batch-size", "16",
     "--epochs", "3", "--ckpt-freq", "2", "--eval-freq", "1",
     "--accumulation-steps", "2", "--disable_amp", "--tag", "t1",
     "--name", "n1", "--output", "out"],
    ["--tasks", "semseg,sal", "--pascal", "/data/pascal", "--eval",
     "--skip_decoder", "--eval_training_freq", "2", "--resume", "x.pth",
     "--opts", "TRAIN.BASE_LR", "1e-3", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]"],
    ["--tasks", "semseg,normals", "--nyud", "/data/nyud", "--throughput",
     "--pretrained", "p.pth", "--optim", "sgd", "--freeze_backbone",
     "--use-checkpoint", "--fused_window_process", "--local_rank", "1"],
]


@pytest.mark.parametrize("argv", CLI_ARGS,
                         ids=[str(i) for i in range(len(CLI_ARGS))])
def test_get_config_matches_jax(argv):
    """The port's parser and ``get_config`` against the JAX package's
    ``get_config`` on the same namespace: flags, dataset choice, tasks and
    the output directory."""
    args = build_parser().parse_args(["--cfg", FLAGSHIP, *argv])
    got, want = pconfig.get_config(args), jconfig.get_config(args)
    assert got.to_dict() == want.to_dict()
    assert got.OUTPUT == os.path.join(args.output, got.MODEL.NAME, got.TAG)


def test_decoder_map_matches_jax(tmp_path):
    path = tmp_path / "map.json"
    path.write_text(json.dumps({"semseg": "segformer"}))
    args = build_parser().parse_args(
        ["--cfg", FLAGSHIP, "--tasks", "semseg,sal", "--decoder_map",
         str(path)])
    got, want = pconfig.get_config(args), jconfig.get_config(args)
    assert got.to_dict() == want.to_dict()
    assert got.MODEL.DECODER_HEAD["semseg"] == "segformer"
    with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
        pconfig.from_config(got)


# PyYAML's YAML 1.1 scalars that the configs and --opts use: booleans in
# three spellings, null forms, decimal and 0x ints, floats that need a dot
# and a signed exponent, and the near-misses that stay strings
SCALARS = [
    "yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false",
    "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF", "y", "n",
    "~", "null", "Null", "NULL", "", "0", "-0", "7", "+7", "-12", "09",
    "0x1F", "-0x10", "0o17", "1.0", "1.", "0.", ".5", "-.5", "+0.5", "1e-4",
    "1.0e4", "1.0e-4", "1.0E+4", "5e-4", "5.0e-4", "0.0256", "1.5:2",
    "abc", "a b c", "hrnet", "bfloat16", "_base.yaml", "'quoted'",
    '"dq \\t x"', "'it''s'", "[2, 2, 6, 2]", "[0.0, 0.05]",
    "['_base_mtlora_tiny_448.yaml']", "[[1, 2], [3]]", "[]", "{}",
    "{shared: 64, semseg: 4}", "[yes, no, ~, 1e-4, 1.0e-4]",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_reads_as_safe_load(text):
    want = yaml.safe_load(text)
    got = yaml_subset.loads(text)
    assert got == want and type(got) is type(want), (got, want)


@pytest.mark.parametrize("name", ["flagship", "defaults"])
def test_dump_reads_back_equal(name):
    """``ConfigNode.dump`` is YAML that the port's reader, and PyYAML,
    read back equal to ``to_dict`` (tuples as lists)."""
    cfg = (pconfig.load_config(FLAGSHIP, tasks=PASCAL[1])
           if name == "flagship" else pconfig.default_config())
    want = json.loads(json.dumps(cfg.to_dict()))      # tuples -> lists
    text = cfg.dump()
    assert yaml_subset.loads(text) == want
    assert yaml.safe_load(text) == want


def test_dump_of_awkward_values_reads_back():
    value = {"s": ["yes", "1e-4", "a: b", "# x", "", "null", "é", "x\ny"],
             "f": [1e-5, 1e20, -0.0, 0.1, 3.0],
             "n": None, "b": [True, False], "i": [-3, 0, 10 ** 20],
             "d": {"k": {"deeper": [1, {"x": 2}]}, "empty": {}},
             "l": [[], [1, [2]]]}
    text = yaml_subset.dumps(value)
    assert yaml_subset.loads(text) == value
    assert yaml.safe_load(text) == value


# constructs and numbers no config uses: refused, not misread
UNSUPPORTED = [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: 1\n---\nb: 2",
    "a: [1, 2", "a:\n  - 1\n - 2", "- 1", "A:\n- 1\n- x",
    "A:\n  - k: 1\n    j: [2]\n  - 3\n", "1_000", "010", "0b101", "1:30",
    "1:30.5", ".inf", "-.inf", "+.inf", ".NaN", ".nan", '"\\x41"',
    "a: [1, .nan]",
]


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
def test_dump_refuses_what_the_reader_refuses(value):
    with pytest.raises(ValueError):
        yaml_subset.dumps({"f": value})


def test_empty_documents():
    assert yaml_subset.loads("# nothing\n\n") is None
    assert yaml_subset.loads("") is None
    assert yaml_subset.loads("---\n# only a comment\n") is None
