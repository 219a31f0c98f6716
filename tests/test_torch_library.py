"""The kernel library's ctypes signatures against the C entry points that
the CUDA sources declare. It reads the sources, so it runs without nvcc or
a card: a C entry whose arguments changed while ``library._SIGNATURES``
did not would pass a card index as a stream, or cut a pointer."""

import ctypes
import re

import pytest

from repro_torch.kernels import library

# C parameter and return types as the library declares them to ctypes:
# every pointer as void* (a returned string as char*).
_C_TYPES = {"int": ctypes.c_int, "int32_t": ctypes.c_int32,
            "int64_t": ctypes.c_int64, "uint32_t": ctypes.c_uint32,
            "float": ctypes.c_float}
_ENTRY = re.compile(r'extern "C"\s+([^(]*?)\s*\b(\w+)\s*\(([^)]*)\)')


def _param_type(decl: str):
    if "*" in decl:
        return ctypes.c_void_p
    return _C_TYPES[decl.replace("const", "").split()[0]]


def _return_type(decl: str):
    if "*" in decl:
        return ctypes.c_char_p if "char" in decl else ctypes.c_void_p
    return _C_TYPES[decl.replace("const", "").strip()]


def _entries() -> dict:
    """name -> (argument types, return type) of every ``extern "C"``
    function in the library's sources."""
    out = {}
    for name in library.SOURCES:
        text = (library.CSRC / name).read_text()
        for ret, fn, params in _ENTRY.findall(text):
            params = [p.strip() for p in params.split(",") if p.strip()]
            assert fn not in out, f"{fn} defined twice"
            out[fn] = ([_param_type(p) for p in params], _return_type(ret))
    return out


ENTRIES = _entries()


def test_every_c_entry_has_a_signature():
    assert sorted(ENTRIES) == sorted(library._SIGNATURES)


@pytest.mark.parametrize("name", sorted(library._SIGNATURES))
def test_signature_matches_source(name):
    argtypes, restype = library._SIGNATURES[name]
    want_args, want_ret = ENTRIES[name]
    assert len(argtypes) == len(want_args)
    assert [a.__name__ for a in argtypes] == [a.__name__ for a in want_args]
    assert restype is want_ret
