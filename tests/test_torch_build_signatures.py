"""Each C entry point of ``norma_tpu_torch/csrc/*.cu`` and the ctypes
argument list ``ops/_build.py`` binds it with agree, parameter by
parameter: a mismatch builds and loads without complaint and passes wrong
values on the card, where no CPU test reaches."""

import ctypes
import glob
import os
import re

import pytest

from norma_tpu_torch.ops import _build

_C_TYPES = {
    "int": ctypes.c_int,
    "long long": ctypes.c_int64,
    "unsigned long long": ctypes.c_uint64,
    "float": ctypes.c_float,
}


def _declarations():
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            out[name] = [re.sub(r"\s*\w+$", "", a.strip()) for a in args.split(",")]
    return out


_DECL = _declarations()


def test_every_entry_point_is_bound():
    assert sorted(_DECL) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_point_parameters_match(name):
    want = [ctypes.c_void_p if c.endswith("*") else _C_TYPES[c] for c in _DECL[name]]
    assert _build.SIGNATURES[name] == want
