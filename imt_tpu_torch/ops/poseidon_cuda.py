"""Wrappers of the hand-written CUDA Poseidon kernel (``csrc/poseidon_bn254.cu``).

Counterpart of the public wrappers of ``imt_tpu/ops/poseidon_rns_pallas.py``
(``permute_n``, ``hash2_nodes``, ``hash3_leaf``; a hash of canonical limbs
is ``hashing.hash2`` / ``hash3``), plus the limb <-> node conversions and
``hash_fixed`` of any arity, a sponge of ``permute_n`` launches (nodes
out: ``hash_fixed_nodes``).  Each wrapper takes CUDA tensors only, checks
device, dtype, shape and contiguity, allocates its output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch reports an error.  There is no fallback: a CPU
tensor raises, and the plain version
lives in ``poseidon.py``.  Each launch adds one to the tracer's counter
``cuda.<entry point>``, so a run can show which kernels it reached, and a
hash launch that the library runs on its cooperative kernel (several
threads a lane, at widths up to ``coop_lanes``) one to
``cuda.<entry point>.coop``; ``hashing.py`` counts the hash work its
dispatch chooses on either device.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import torch

from ..utils.observability import count
from . import _build
from .field import LIMBS, WORDS, add_mod_nodes

_init_lock = threading.Lock()
_initialized_devices: set[int] = set()


def _lib_for(device: torch.device) -> ctypes.CDLL:
    """The kernel library, with the constant tables copied to `device`."""
    lib = _build.load("poseidon")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _init_lock:
        if idx not in _initialized_devices:
            from .poseidon_spec import kernel_words
            words = kernel_words()
            with torch.cuda.device(idx):
                err = lib.imt_init_constants(
                    words.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_longlong(words.size))
            if err:
                raise RuntimeError(
                    f"imt_init_constants: CUDA error {err} on cuda:{idx}")
            _initialized_devices.add(idx)
    return lib


def _check(name: str, tensors, lead: tuple) -> int:
    """Validate the inputs of one launch; return the batch width B."""
    b = None
    dev = None
    for x in tensors:
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            where = x.device if isinstance(x, torch.Tensor) else type(x)
            raise ValueError(f"{name}: expected a CUDA tensor, got {where}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {x.dtype}")
        if tuple(x.shape[:-1]) != lead or x.dim() != len(lead) + 1:
            raise ValueError(f"{name}: expected shape {list(lead) + ['B']}, "
                             f"got {list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if b is None:
            b, dev = x.shape[-1], x.device
        elif x.shape[-1] != b or x.device != dev:
            raise ValueError(f"{name}: inputs differ in width or device")
    return b


def _launch(name: str, device: torch.device, fn, *args,
            hash_lanes: int | None = None) -> None:
    """Launch `fn` on the current stream of `device` and count it; a hash
    launch passes its width as `hash_lanes`, and the library says which
    kernel that width took."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
        coop = hash_lanes is not None and _build.load(
            "poseidon").imt_hash_lane_threads(hash_lanes) > 1
    if err:
        raise RuntimeError(f"{name}: CUDA launch error {err}")
    count("cuda." + name)
    if coop:
        count(f"cuda.{name}.coop")


def coop_lanes(device: torch.device) -> int:
    """The widest hash launch that takes the cooperative kernels on
    `device`, found by bisection of the library's own choice (a width
    takes them iff it is at most this)."""
    lib = _lib_for(device)
    lo, hi = 0, 1 << 40
    with torch.cuda.device(device):
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if lib.imt_hash_lane_threads(mid) > 1:
                lo = mid
            else:
                hi = mid - 1
    return lo


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def permute_n(st: torch.Tensor, n_perms: int = 1) -> torch.Tensor:
    """n_perms chained permutations of node states int32[3, 8, B]."""
    b = _check("permute_n", [st], (3, WORDS))
    lib = _lib_for(st.device)
    out = torch.empty_like(st)
    _launch("permute_n", st.device, lib.imt_permute_n, _ptr(st), _ptr(out),
            ctypes.c_longlong(b), ctypes.c_int(n_perms))
    return out


def hash2_nodes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) on nodes int32[8, B] x2 -> nodes int32[8, B]."""
    w = _check("hash2_nodes", [a, b], (WORDS,))
    lib = _lib_for(a.device)
    out = torch.empty_like(a)
    _launch("hash2_nodes", a.device, lib.imt_hash2_nodes, _ptr(a), _ptr(b),
            _ptr(out), ctypes.c_longlong(w), hash_lanes=w)
    return out


def hash3_leaf(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """H(a, b, c) on canonical limbs int32[16, B] x3 -> nodes int32[8, B]."""
    w = _check("hash3_leaf", [a, b, c], (LIMBS,))
    lib = _lib_for(a.device)
    out = torch.empty((WORDS, w), dtype=torch.int32, device=a.device)
    _launch("hash3_leaf", a.device, lib.imt_hash3_leaf, _ptr(a), _ptr(b),
            _ptr(c), _ptr(out), ctypes.c_longlong(w), hash_lanes=w)
    return out


def limbs_to_nodes(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs int32[16, B] -> nodes int32[8, B] (reduced mod p)."""
    w = _check("limbs_to_nodes", [limbs], (LIMBS,))
    lib = _lib_for(limbs.device)
    out = torch.empty((WORDS, w), dtype=torch.int32, device=limbs.device)
    _launch("limbs_to_nodes", limbs.device, lib.imt_limbs_to_nodes,
            _ptr(limbs), _ptr(out), ctypes.c_longlong(w))
    return out


def nodes_to_limbs(nodes: torch.Tensor) -> torch.Tensor:
    """Nodes int32[8, B] -> canonical limbs int32[16, B]."""
    w = _check("nodes_to_limbs", [nodes], (WORDS,))
    lib = _lib_for(nodes.device)
    out = torch.empty((LIMBS, w), dtype=torch.int32, device=nodes.device)
    _launch("nodes_to_limbs", nodes.device, lib.imt_nodes_to_limbs,
            _ptr(nodes), _ptr(out), ctypes.c_longlong(w))
    return out


@lru_cache(maxsize=None)
def _sponge_words(device: torch.device):
    """The sponge's initial capacity word 2^64 and the pad word 1, as node
    columns int32[8, 1] on `device`."""
    from .poseidon_spec import default_spec, to_words
    s = default_spec()
    col = lambda w: torch.as_tensor(to_words(w).view("int32")[:, None],
                                    device=device)
    return col(s.iv_mont[0]), col(s.one_mont)


def hash_fixed(cols) -> torch.Tensor:
    """Fixed-length hash of any arity n >= 1 on canonical limbs int32[16, B]
    x n -> canonical limbs int32[16, B]; the sponge of ``poseidon.hash_fixed``
    with each permutation one K1 launch (``permute_n(st, 1)``): n // 2 + 1
    launches, between them the absorption of the next chunk, a mod-p
    addition of node words in plain torch ops (``field.add_mod_nodes``, as
    XLA did it for the TPU; one call a chunk, its words side by side),
    which keeps every word below p as K1 requires.
    No host sync."""
    return nodes_to_limbs(hash_fixed_nodes(cols))


def hash_fixed_nodes(cols) -> torch.Tensor:
    """``hash_fixed`` with the squeezed word left as nodes int32[8, B]
    (contiguous): the same K1 launches, without the final conversion."""
    if not cols:
        raise ValueError("hash_fixed needs at least one input")
    b = _check("hash_fixed", cols, (LIMBS,))
    iv, one = _sponge_words(cols[0].device)
    seq = [limbs_to_nodes(c) for c in cols] + [one.expand(WORDS, b)]
    st = permute_n(torch.stack([iv.expand(WORDS, b), seq[0], seq[1]]), 1)
    for k in range(2, len(seq), 2):
        chunk = seq[k:k + 2]                  # words 1.. absorb the chunk
        w = 1 + len(chunk)
        add = add_mod_nodes(st[1:w].transpose(0, 1),
                            torch.stack(chunk, dim=1)).transpose(0, 1)
        st = permute_n(torch.cat([st[:1], add, st[w:]]), 1)
    return st[1]
