"""ops/nvcc.py's shared kernel scaffolding, on the CPU: each wrapper's
``Library`` types exactly the C functions its source exports, with their C
types and parameter counts, and ``forward_only`` refuses exactly the calls
that need a gradient. The launches themselves run only on the card
(tests/test_torch_cuda.py)."""

import ctypes
import importlib
import re

import pytest
import torch

from exemplar_vae_tpu_torch.ops.nvcc import forward_only

WRAPPERS = ("pairwise_lse", "masked_epilogue", "gated_epilogue")
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _exports(source: str):
    """name -> (parameter ctypes, return ctype) of the functions defined in
    the source's ``extern "C"`` block."""
    block = source[source.index('extern "C"'):]
    out = {}
    for ret, name, params in re.findall(
            r"^(int|long long) (\w+)\(([^)]*)\)\s*\{", block, re.M):
        types = []
        for p in filter(None, (q.strip() for q in params.split(","))):
            if "*" in p:
                types.append(ctypes.c_void_p)
            else:
                types.append(_C_TYPES[p.rsplit(" ", 1)[0]])
        out[name] = (types, _C_TYPES[ret])
    return out


@pytest.mark.parametrize("name", WRAPPERS)
def test_library_types_exactly_the_exported_functions(name):
    lib = importlib.import_module(f"exemplar_vae_tpu_torch.ops.{name}").LIB
    exported = _exports(lib.source.read_text())
    assert lib.stem == name and lib.source.name == f"{name}.cu"
    assert set(lib.signatures) == set(exported)
    for fn, (argtypes, restype) in lib.signatures.items():
        assert (list(argtypes), restype) == exported[fn], fn


@pytest.mark.parametrize("name", WRAPPERS)
def test_build_is_the_library_build_and_nothing_is_built_at_import(name):
    mod = importlib.import_module(f"exemplar_vae_tpu_torch.ops.{name}")
    assert mod.build == mod.LIB.build
    if not torch.cuda.is_available():
        assert mod.LIB.lib is None


def test_forward_only_refuses_exactly_the_calls_that_need_a_gradient():
    x, w = torch.ones(2), torch.ones(2, requires_grad=True)
    forward_only("test", "advice", x, x)
    with torch.no_grad():
        forward_only("test", "advice", x, w)
    with pytest.raises(RuntimeError,
                       match="^the test op is forward-only; advice$"):
        forward_only("test", "advice", x, w)
