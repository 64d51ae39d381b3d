"""Paged-KV-cache attention: decode, chunked prefill and one-shot
prefill.

Counterparts of ``mxnet_tpu/pallas/attention.py``
``paged_decode_attend``, ``paged_chunk_prefill_attend`` and
``paged_prefill_attend``, with the same signatures and layouts: caches
``(num_blocks, block_size, H, D)`` addressed through an int32 block
table, queries and chunk rows seq-major.  The kernels are
``csrc/paged_attention.cu`` (design note in the source; decode splits
each slot's keys over the blocks of a thread block cluster, whose rank
0 combines them; the one-shot and chunked prefills run the f32 flash
forward of ``csrc/attention_f32.cuh``, split TF32 on the tensor cores,
or, for bf16 q/k/v over bf16 caches, the bf16 tile of
``csrc/attention_bf16.cuh`` (exact bf16 Q K^T products, P V in bf16 hi
and lo halves), the chunked one over key ranges of the context that a
second launch combines).  f16 q/k/v over f16 caches, the float16
serving path, run the same tile in f16 (P scaled by 2^12 into its
halves); f16 pairs with f16 only.  Each launch is also counted under its
q type (``LAUNCHES_BY_DTYPE["paged_prefill_attend:bfloat16"]``,
``"paged_decode_attend:float16"``).
Beside each wrapper is its plain PyTorch version: the CPU path and the
kernel's yardstick on the card.

The two prefills write their K/V rows into the caches IN PLACE and
return the same cache tensors: the counterpart of the JAX kernels'
input/output-aliased caches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_same_16bit,
                       check_tensor, count_launch, count_plain, on_cpu)

__all__ = ["paged_decode_attend", "paged_decode_attend_plain",
           "paged_chunk_prefill_attend", "paged_chunk_prefill_attend_plain",
           "chunk_plan", "decode_plan",
           "paged_prefill_attend", "paged_prefill_attend_plain"]

_DECODE = "paged_decode_attend"
_CHUNK = "paged_chunk_prefill_attend"
_PREFILL = "paged_prefill_attend"
# the decode kernel takes head_dim up to 8192 and block_size up to 128;
# the chunk and one-shot prefills have no head_dim limit
_DECODE_MAX_D = 8192
_INT = (torch.int32,)
# the chunk kernel's launch plan (chunk_plan): an H100's streaming
# multiprocessors, the key ranges it picks from (multiples of the
# kernel's 32-key stage), and the warps it aims to keep busy an SM for
# four-warp and one-warp blocks (a one-warp block walks its key tiles
# alone, so it wants shorter ranges: tools/torch_flash_tune.py --chunk)
_SMS = 132
_KEY_RANGES = (1024, 512, 256, 128, 64)
_WARPS_PER_SM = {4: 4, 1: 8}
# the decode kernel's plan (decode_plan): a slot's ranges form one thread
# block cluster, at most 8 (the portable cluster size); the blocks an SM
# it aims for (tools/torch_flash_tune.py --decode)
_DECODE_CLUSTER = 8
_DECODE_BLOCKS_PER_SM = 3


def _lib():
    return _bind(_build.load("paged_attention"))


def _bind(lib):
    """Set the argument types of a loaded ``paged_attention`` library
    (once); returns it."""
    if lib.mx_paged_decode.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mx_paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        f, i, i, i, p]
        lib.mx_paged_decode.restype = i
        lib.mx_paged_decode_smem.argtypes = [i, i, i, i, i]
        lib.mx_paged_decode_smem.restype = ctypes.c_size_t
        lib.mx_paged_chunk_prefill.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, i, i, i, i, i, i, i, i, f,
                                               i, i, i, p]
        lib.mx_paged_chunk_prefill.restype = i
        lib.mx_paged_chunk_prefill_smem.argtypes = [i, i, i, i, i]
        lib.mx_paged_chunk_prefill_smem.restype = ctypes.c_size_t
        lib.mx_paged_prefill.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, i, f, i, i, i, p]
        lib.mx_paged_prefill.restype = i
        lib.mx_paged_prefill_smem.argtypes = [i, i]
        lib.mx_paged_prefill_smem.restype = ctypes.c_size_t
    return lib


def _check_caches(kernel, q, k_cache, v_cache):
    check_tensor(kernel, "k_cache", k_cache, dtypes=FLOAT_TYPES, ndim=4)
    check_tensor(kernel, "v_cache", v_cache, dtypes=(k_cache.dtype,),
                 shape=k_cache.shape)
    check_same_16bit(kernel, "q", q, "the caches", k_cache)


# ----------------------------------------------------------------------
# decode: one query per slot against cache rows [0, positions[c]]
# ----------------------------------------------------------------------
def paged_decode_attend_plain(q, k_cache, v_cache, block_table, positions,
                              *, scale):
    """Plain PyTorch decode attention: gathers each slot's whole
    addressable context through the table and masks it causally.
    Inactive slots (``positions < 0``) return zeros."""
    count_plain(_DECODE)
    nb, bs, H, D = k_cache.shape
    M = block_table.shape[1]
    j = torch.arange(M * bs, device=q.device)
    table = block_table.long().clamp(0, nb - 1)
    ridx = table[:, j // bs] * bs + j % bs                       # (C, ctx)
    kctx = k_cache.reshape(nb * bs, H, D)[ridx].float()          # (C, ctx, H, D)
    vctx = v_cache.reshape(nb * bs, H, D)[ridx].float()
    pos = positions.long()
    s = torch.einsum("che,cjhe->chj", q.float(), kctx) * scale
    s = s.masked_fill(j[None, None, :] > pos[:, None, None], -1e30)
    o = torch.einsum("chj,cjhe->che", torch.softmax(s, dim=-1), vctx)
    o = torch.where((pos >= 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


@functools.lru_cache(maxsize=None)
def decode_plan(C, H, D, bs, M):
    """The decode kernel's launch plan, a function of the static shapes
    alone (never of ``positions``, which live on the device): each slot's
    keys split evenly over ``ranges`` blocks of 4 warps (a thread block
    cluster, whose rank 0 combines them), the fewest of 1, 2, 4, 8 whose
    ``blocks = C * H * ranges`` give every SM ``_DECODE_BLOCKS_PER_SM``
    blocks, else 8 (the split itself is worked out on the device from
    the position).  ``blocks`` counts one column chunk of head_dim."""
    ranges = 1
    while ranges < _DECODE_CLUSTER and \
            C * H * ranges < _DECODE_BLOCKS_PER_SM * _SMS:
        ranges *= 2
    return {"ranges": ranges, "blocks": C * H * ranges}


def paged_decode_attend(q, k_cache, v_cache, block_table, positions, *,
                        scale):
    """Paged decode attention: ``q (C, H, D)`` against cache rows
    ``[0, positions[c]]`` addressed through ``block_table (C, M)``; the
    caches ``(num_blocks, block_size, H, D)`` already hold the current
    token's K/V (the scatter is in ops/nn.py).  Returns ``(C, H, D)`` in
    ``q.dtype``; inactive slots (``positions < 0``) return zeros.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.  The kernel splits each slot's keys over the ranges of
    :func:`decode_plan` and combines them in a thread block cluster."""
    if on_cpu(_DECODE, q, k_cache, v_cache, block_table, positions):
        return paged_decode_attend_plain(q, k_cache, v_cache, block_table,
                                         positions, scale=scale)
    check_tensor(_DECODE, "q", q, dtypes=FLOAT_TYPES, ndim=3)
    C, H, D = q.shape
    _check_caches(_DECODE, q, k_cache, v_cache)
    nb, bs = k_cache.shape[:2]
    if tuple(k_cache.shape[2:]) != (H, D):
        raise MXNetError("%s: caches hold (H, D) = %s, q has %s"
                         % (_DECODE, tuple(k_cache.shape[2:]), (H, D)))
    check_tensor(_DECODE, "block_table", block_table, dtypes=_INT, ndim=2)
    if block_table.shape[0] != C:
        raise MXNetError("%s: block_table has %d rows for %d slots"
                         % (_DECODE, block_table.shape[0], C))
    check_tensor(_DECODE, "positions", positions, dtypes=_INT, shape=(C,))
    if bs > 128 or D > _DECODE_MAX_D:
        raise MXNetError("%s: the kernel takes block_size <= 128 and "
                         "head_dim <= %d, got %d and %d"
                         % (_DECODE, _DECODE_MAX_D, bs, D))
    if C > 65535 or H > 65535:
        raise MXNetError("%s: the kernel takes at most 65535 slots and "
                         "heads, got %d and %d" % (_DECODE, C, H))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    M = block_table.shape[1]
    if M * bs == 0:             # no cache row: every slot attends nothing
        return out.zero_()
    lib = _lib()
    err = lib.mx_paged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(), C, H,
        D, bs, M, decode_plan(C, H, D, bs, M)["ranges"], float(scale),
        DTYPE_CODE[q.dtype], DTYPE_CODE[k_cache.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _DECODE, err)
    count_launch(_DECODE, q.dtype)
    return out


# ----------------------------------------------------------------------
# chunked prefill: a K-row chunk at [start, start + len) over the cache
# ----------------------------------------------------------------------
def paged_chunk_prefill_attend_plain(q, k, v, k_cache, v_cache, block_table,
                                     start, lengths, *, scale):
    """Plain PyTorch chunked prefill: scatter the chunk's real rows into
    the caches in place, then attend each chunk query causally over the
    gathered context.  Returns ``(out, k_cache, v_cache)``."""
    count_plain(_CHUNK)
    B, K, H, D = q.shape
    nb, bs = k_cache.shape[:2]
    M = block_table.shape[1]
    kf = k_cache.view(nb * bs, H, D)
    vf = v_cache.view(nb * bs, H, D)
    table = block_table.long()
    j = torch.arange(K, device=q.device)
    apos = start.long()[:, None] + j[None, :]                    # (B, K)
    real = j[None, :] < lengths.long()[:, None]
    base = table.gather(1, (apos // bs).clamp(0, M - 1))
    widx = (base * bs + apos % bs)[real]
    kf[widx] = k[real].to(kf.dtype)
    vf[widx] = v[real].to(vf.dtype)
    jk = torch.arange(M * bs, device=q.device)
    ridx = table[:, jk // bs].clamp(0, nb - 1) * bs + jk % bs    # (B, ctx)
    kctx = kf[ridx].float()
    vctx = vf[ridx].float()
    s = torch.einsum("bqhe,bjhe->bhqj", q.float(), kctx) * scale
    mask = jk[None, None, :] <= apos[:, :, None]                 # (B, K, ctx)
    s = s.masked_fill(~mask[:, None], -1e30)
    o = torch.einsum("bhqj,bjhe->bqhe", torch.softmax(s, dim=-1), vctx)
    return o.to(q.dtype), k_cache, v_cache


def chunk_plan(B, K, H, D, ctx):
    """The chunk kernel's launch plan, a function of the static shapes
    alone (never of ``start`` or ``lengths``, which live on the device):
    ``warps`` a block (one for spans of up to 16 rows, four for longer
    chunks: 16 query rows a warp), ``key_range`` (the keys a block
    takes: the largest of ``_KEY_RANGES`` whose blocks over the ``ctx =
    M * block_size`` keys a row's table addresses still give
    ``_WARPS_PER_SM[warps]`` warps an SM), ``ranges`` (``ceil(ctx /
    key_range)``, the workspace's range axis) and ``blocks`` (the first
    kernel's grid: query tiles x ranges x rows x heads x 128-column
    chunks of head_dim)."""
    warps = 1 if K <= 16 else 4
    tiles = -(-K // (16 * warps))
    for key_range in _KEY_RANGES:
        ranges = -(-ctx // key_range)
        if B * H * tiles * ranges * warps >= _WARPS_PER_SM[warps] * _SMS:
            break
    return {"warps": warps, "key_range": key_range, "ranges": ranges,
            "blocks": tiles * ranges * B * H * -(-D // 128)}


def paged_chunk_prefill_attend(q, k, v, k_cache, v_cache, block_table, start,
                               lengths, *, scale):
    """Chunked prefill attention over an EXISTING cache: chunk rows
    ``q/k/v (B, K, H, D)`` sit at absolute positions ``[start[b],
    start[b] + lengths[b])``; each attends causally to the whole context
    so far.  The chunk's real K/V rows are written into the caches in
    place; rows past ``lengths[b]`` are padding (never written, outputs
    zeros) and ``lengths[b] == 0`` leaves the caches byte-identical.
    Returns ``(out (B, K, H, D), k_cache, v_cache)``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.  The
    kernel splits each row's keys into ranges (:func:`chunk_plan`) and
    combines them in a second launch, from workspaces allocated here."""
    if on_cpu(_CHUNK, q, k, v, k_cache, v_cache, block_table, start,
              lengths):
        return paged_chunk_prefill_attend_plain(
            q, k, v, k_cache, v_cache, block_table, start, lengths,
            scale=scale)
    check_tensor(_CHUNK, "q", q, dtypes=FLOAT_TYPES, ndim=4)
    B, K, H, D = q.shape
    check_tensor(_CHUNK, "k", k, dtypes=(q.dtype,), shape=q.shape)
    check_tensor(_CHUNK, "v", v, dtypes=(q.dtype,), shape=q.shape)
    _check_caches(_CHUNK, q, k_cache, v_cache)
    nb, bs = k_cache.shape[:2]
    if tuple(k_cache.shape[2:]) != (H, D):
        raise MXNetError("%s: caches hold (H, D) = %s, q has %s"
                         % (_CHUNK, tuple(k_cache.shape[2:]), (H, D)))
    check_tensor(_CHUNK, "block_table", block_table, dtypes=_INT, ndim=2)
    if block_table.shape[0] != B:
        raise MXNetError("%s: block_table has %d rows for %d chunks"
                         % (_CHUNK, block_table.shape[0], B))
    check_tensor(_CHUNK, "start", start, dtypes=_INT, shape=(B,))
    check_tensor(_CHUNK, "lengths", lengths, dtypes=_INT, shape=(B,))
    M = block_table.shape[1]
    if B * H > 65535:
        raise MXNetError("%s: the kernel takes batch * heads <= 65535, got "
                         "%d" % (_CHUNK, B * H))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, k_cache, v_cache
    if M * bs == 0:             # no cache row: every row is padding
        return out.zero_(), k_cache, v_cache
    plan = chunk_plan(B, K, H, D, M * bs)
    # one workspace: each range's partial sums (rows x D), then each
    # row's running max and sum (rows x 2)
    rows = B * H * plan["ranges"] * K
    ws = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.mx_paged_chunk_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), block_table.data_ptr(), start.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.data_ptr() + rows * D * 4,
        B, K, H, D, bs, M, plan["key_range"], plan["warps"], float(scale),
        DTYPE_CODE[q.dtype], DTYPE_CODE[k_cache.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _CHUNK, err)
    count_launch(_CHUNK, q.dtype)
    return out, k_cache, v_cache


# ----------------------------------------------------------------------
# one-shot prefill: causal attention over a padded prompt batch, with
# each row's first lengths[b] K/V rows scattered into the cache
# ----------------------------------------------------------------------
def _check_prefill_table(q, k_cache, block_table):
    """The JAX function's shape contract: the table must address every
    block a length-S prompt can fill."""
    S, bs, M = q.shape[1], k_cache.shape[1], block_table.shape[1]
    if M < -(-S // bs):
        raise MXNetError("%s: block_table width %d < %d blocks needed for a "
                         "%d-token prompt at block_size %d"
                         % (_PREFILL, M, -(-S // bs), S, bs))


def paged_prefill_attend_plain(q, k, v, k_cache, v_cache, block_table,
                               lengths, *, scale):
    """Plain PyTorch one-shot prefill: every one of the S query rows
    attends causally to the input keys, and rows ``< lengths[b]`` are
    scattered into the caches in place (table entries past a row's last
    real block are never used).  Returns ``(out, k_cache, v_cache)``."""
    count_plain(_PREFILL)
    _check_prefill_table(q, k_cache, block_table)
    B, S, H, D = q.shape
    nb, bs = k_cache.shape[:2]
    M = block_table.shape[1]
    s = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhe->bqhe", torch.softmax(s, dim=-1), v.float())
    j = torch.arange(S, device=q.device)
    real = j[None, :] < lengths.long().clamp(0, M * bs)[:, None]   # (B, S)
    base = block_table.long()[:, (j // bs).clamp(0, M - 1)]         # (B, S)
    widx = (base * bs + j % bs)[real]
    k_cache.view(nb * bs, H, D)[widx] = k[real].to(k_cache.dtype)
    v_cache.view(nb * bs, H, D)[widx] = v[real].to(v_cache.dtype)
    return o.to(q.dtype), k_cache, v_cache


def paged_prefill_attend(q, k, v, k_cache, v_cache, block_table, lengths, *,
                         scale):
    """One-shot prefill attention: ``q/k/v (B, S, H, D)`` seq-major,
    every query row attending causally to the row's own keys (any S;
    keys at or past S do not exist), with the first ``lengths[b]`` K/V
    rows of each row written into the caches in place at table block
    ``block_table[b, j // bs]``, row ``j % bs``.  ``lengths[b] <= S`` is
    the caller's contract; ``lengths[b] == 0`` leaves the caches
    byte-identical.  Returns ``(out (B, S, H, D), k_cache, v_cache)``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if on_cpu(_PREFILL, q, k, v, k_cache, v_cache, block_table, lengths):
        return paged_prefill_attend_plain(q, k, v, k_cache, v_cache,
                                          block_table, lengths, scale=scale)
    check_tensor(_PREFILL, "q", q, dtypes=FLOAT_TYPES, ndim=4)
    B, S, H, D = q.shape
    check_tensor(_PREFILL, "k", k, dtypes=(q.dtype,), shape=q.shape)
    check_tensor(_PREFILL, "v", v, dtypes=(q.dtype,), shape=q.shape)
    _check_caches(_PREFILL, q, k_cache, v_cache)
    nb, bs = k_cache.shape[:2]
    if tuple(k_cache.shape[2:]) != (H, D):
        raise MXNetError("%s: caches hold (H, D) = %s, q has %s"
                         % (_PREFILL, tuple(k_cache.shape[2:]), (H, D)))
    check_tensor(_PREFILL, "block_table", block_table, dtypes=_INT, ndim=2)
    if block_table.shape[0] != B:
        raise MXNetError("%s: block_table has %d rows for %d prompts"
                         % (_PREFILL, block_table.shape[0], B))
    _check_prefill_table(q, k_cache, block_table)
    check_tensor(_PREFILL, "lengths", lengths, dtypes=_INT, shape=(B,))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out, k_cache, v_cache
    lib = _lib()
    err = lib.mx_paged_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, H, D, bs, block_table.shape[1], float(scale),
        DTYPE_CODE[q.dtype], DTYPE_CODE[k_cache.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _PREFILL, err)
    count_launch(_PREFILL, q.dtype)
    return out, k_cache, v_cache
