"""The ctypes bindings of the hand-written kernels against their C signatures.

Every ``extern "C" int name(...)`` in ``fedvit_torch/csrc/*.cu`` is called
through ctypes with the ``argtypes`` its library loader sets. A pointer bound
as ``c_int`` would be cut to 32 bits, and a wrong count shifts every argument
after it, so each entry's ``argtypes`` must match its C parameters in count
and kind (``void*`` → ``c_void_p``, ``int`` → ``c_int``, ``float`` →
``c_float``) and its ``restype`` must be ``c_int``. The loaders run on the CPU
with ``kernels.load`` replaced by a recorder, so nothing is compiled.
"""

import ctypes
import re

import pytest

from fedvit_torch.core import kernels
from fedvit_torch.ops import flash_attention, layer_norm, randaugment, row_shift

LOADERS = (flash_attention._library, flash_attention._bwd_library,
           flash_attention._xqkv_library, flash_attention._xqkv_bwd_library,
           flash_attention._window_library, flash_attention._window_bwd_library,
           layer_norm._library, row_shift._library, randaugment._library)

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _kind(param: str):
    param = re.sub(r"/\*.*?\*/", "", param).strip()
    if "*" in param:
        return ctypes.c_void_p
    if re.match(r"(const\s+)?int\b", param):
        return ctypes.c_int
    if re.match(r"(const\s+)?float\b", param):
        return ctypes.c_float
    raise ValueError(f"parameter of no known kind: {param!r}")


def c_entries():
    """(library, entry, [ctypes kind of each parameter]) for every entry."""
    found = []
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in _ENTRY.findall(text):
            kinds = [_kind(p) for p in params.split(",") if p.strip()]
            found.append((src.stem, name, kinds))
    return found


ENTRIES = c_entries()


class _Function:
    argtypes = None
    restype = None


class _Library:
    """Stands in for a loaded ``ctypes.CDLL``: records what is set on each
    function a loader touches."""

    def __init__(self, name):
        self.name = name
        self.functions = {}

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return self.functions.setdefault(attr, _Function())


@pytest.fixture
def bound(monkeypatch):
    """{library name: _Library} as the loaders bind them."""
    libs = {}
    monkeypatch.setattr(kernels, "load",
                        lambda name: libs.setdefault(name, _Library(name)))
    for loader in LOADERS:
        loader.cache_clear()
    try:
        for loader in LOADERS:
            loader()
        yield libs
    finally:
        for loader in LOADERS:
            loader.cache_clear()


def test_every_source_has_entries_and_a_loader():
    assert {lib for lib, _, _ in ENTRIES} == set(kernels.SOURCES)
    assert any(name == "gemm_product" for _, name, _ in ENTRIES)


@pytest.mark.parametrize("lib,name,kinds", ENTRIES,
                         ids=[f"{lib}.{name}" for lib, name, _ in ENTRIES])
def test_argtypes_match_the_c_signature(bound, lib, name, kinds):
    assert lib in bound, f"no loader loads {lib}"
    fn = bound[lib].functions.get(name)
    assert fn is not None, f"{lib}.{name} is not bound"
    assert fn.argtypes is not None, f"{lib}.{name} has no argtypes"
    assert list(fn.argtypes) == kinds, (
        f"{lib}.{name}: argtypes {[t.__name__ for t in fn.argtypes]} against "
        f"the C parameters {[t.__name__ for t in kinds]}")
    assert fn.restype is ctypes.c_int
