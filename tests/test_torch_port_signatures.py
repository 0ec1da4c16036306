"""The ctypes argument types of the port's kernel library against the C
entry points they call.

``mtlora_tpu_torch/ops/_build.py:SIGNATURES`` declares, for every
``extern "C" int mtlora_*(...)`` of ``ops/csrc/*.cu``, the ctypes type of
each parameter. A mismatch (a pointer passed as a 32-bit int, an argument
left out) shows only on the card, as a wrong result or a fault; here each
declaration is read from its source and its parameter kinds are held to
the table: a pointer is ``c_void_p``, ``int`` ``c_int``, ``float``
``c_float``, ``unsigned`` ``c_uint``.
"""

import ctypes
import re

import pytest

from mtlora_tpu_torch.ops import _build

DECL = re.compile(r'extern\s+"C"\s+int\s+(mtlora_\w+)\s*\(([^)]*)\)', re.S)
KINDS = {"int": ctypes.c_int, "float": ctypes.c_float,
         "unsigned": ctypes.c_uint}


def _declarations() -> dict:
    decls = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in DECL.findall(src.read_text()):
            assert name not in decls, f"{name} declared twice"
            decls[name] = (src.name, [p.strip() for p in params.split(",")])
    return decls


DECLS = _declarations()


def _kind(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return KINDS[param.split()[0]]


@pytest.mark.parametrize("name", sorted(DECLS))
def test_argument_types_match_the_c_declaration(name):
    source, params = DECLS[name]
    assert name in _build.SIGNATURES, f"{name} ({source}) has no signature"
    want = [_kind(p) for p in params]
    got = _build.SIGNATURES[name]
    assert len(got) == len(want), (
        f"{name}: {len(got)} argument types for {len(want)} parameters")
    for i, (g, w, p) in enumerate(zip(got, want, params)):
        assert g is w, f"{name} argument {i} ({p}): {g.__name__}, not {w.__name__}"


def test_every_signature_is_declared():
    assert set(_build.SIGNATURES) == set(DECLS)
