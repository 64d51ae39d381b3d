"""Paged-KV-cache attention: decode and chunked prefill.

Counterparts of ``mxnet_tpu/pallas/attention.py``
``paged_decode_attend`` and ``paged_chunk_prefill_attend``, with the
same signatures and layouts: caches ``(num_blocks, block_size, H, D)``
addressed through an int32 block table, queries and chunk rows
seq-major.  The kernels are ``csrc/paged_attention.cu`` (design note in
the source).  Beside each wrapper is its plain PyTorch version: the CPU
path and the kernel's yardstick on the card.

The chunk prefill writes the chunk's K/V rows into the caches IN PLACE
and returns the same cache tensors: the counterpart of the JAX kernel's
input/output-aliased caches.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dispatch import (DTYPE_CODE, FLOAT_TYPES, check_tensor, count_launch,
                       count_plain, on_cpu)

__all__ = ["paged_decode_attend", "paged_decode_attend_plain",
           "paged_chunk_prefill_attend", "paged_chunk_prefill_attend_plain"]

_DECODE = "paged_decode_attend"
_CHUNK = "paged_chunk_prefill_attend"
_MAX_SMEM = 232448             # bytes of shared memory a block may use
_INT = (torch.int32,)


def _lib():
    lib = _build.load("paged_attention")
    if lib.mx_paged_decode.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mx_paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f,
                                        i, i, i, p]
        lib.mx_paged_decode.restype = i
        lib.mx_paged_chunk_prefill.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                               i, i, i, i, i, f, i, i, i, p]
        lib.mx_paged_chunk_prefill.restype = i
        lib.mx_paged_chunk_prefill_smem.argtypes = [i]
        lib.mx_paged_chunk_prefill_smem.restype = ctypes.c_size_t
    return lib


def _check_caches(kernel, k_cache, v_cache):
    check_tensor(kernel, "k_cache", k_cache, dtypes=FLOAT_TYPES, ndim=4)
    check_tensor(kernel, "v_cache", v_cache, dtypes=(k_cache.dtype,),
                 shape=k_cache.shape)


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


def paged_decode_attend(q, k_cache, v_cache, block_table, positions, *,
                        scale):
    """Paged decode attention: ``q (C, H, D)`` against cache rows
    ``[0, positions[c]]`` addressed through ``block_table (C, M)``; the
    caches ``(num_blocks, block_size, H, D)`` already hold the current
    token's K/V (the scatter is in ops/nn.py).  Returns ``(C, H, D)`` in
    ``q.dtype``; inactive slots (``positions < 0``) return zeros.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if on_cpu(_DECODE, q, k_cache, v_cache, block_table, positions):
        return paged_decode_attend_plain(q, k_cache, v_cache, block_table,
                                         positions, scale=scale)
    check_tensor(_DECODE, "q", q, dtypes=FLOAT_TYPES, ndim=3)
    C, H, D = q.shape
    _check_caches(_DECODE, k_cache, v_cache)
    nb, bs = k_cache.shape[:2]
    if tuple(k_cache.shape[2:]) != (H, D):
        raise MXNetError("%s: caches hold (H, D) = %s, q has %s"
                         % (_DECODE, tuple(k_cache.shape[2:]), (H, D)))
    check_tensor(_DECODE, "block_table", block_table, dtypes=_INT, ndim=2)
    if block_table.shape[0] != C:
        raise MXNetError("%s: block_table has %d rows for %d slots"
                         % (_DECODE, block_table.shape[0], C))
    check_tensor(_DECODE, "positions", positions, dtypes=_INT, shape=(C,))
    if bs > 128 or D > 256:
        raise MXNetError("%s: the kernel takes block_size <= 128 and "
                         "head_dim <= 256, got %d and %d" % (_DECODE, bs, D))
    out = torch.empty_like(q)
    if C == 0 or H == 0:
        return out
    lib = _lib()
    err = lib.mx_paged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(), C, H,
        D, bs, block_table.shape[1], float(scale), DTYPE_CODE[q.dtype],
        DTYPE_CODE[k_cache.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _DECODE, err)
    count_launch(_DECODE)
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


def paged_chunk_prefill_attend(q, k, v, k_cache, v_cache, block_table, start,
                               lengths, *, scale):
    """Chunked prefill attention over an EXISTING cache: chunk rows
    ``q/k/v (B, K, H, D)`` sit at absolute positions ``[start[b],
    start[b] + lengths[b])``; each attends causally to the whole context
    so far.  The chunk's real K/V rows are written into the caches in
    place; rows past ``lengths[b]`` are padding (never written, outputs
    don't-care) and ``lengths[b] == 0`` leaves the caches byte-identical.
    Returns ``(out (B, K, H, D), k_cache, v_cache)``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if on_cpu(_CHUNK, q, k, v, k_cache, v_cache, block_table, start,
              lengths):
        return paged_chunk_prefill_attend_plain(
            q, k, v, k_cache, v_cache, block_table, start, lengths,
            scale=scale)
    check_tensor(_CHUNK, "q", q, dtypes=FLOAT_TYPES, ndim=4)
    B, K, H, D = q.shape
    check_tensor(_CHUNK, "k", k, dtypes=(q.dtype,), shape=q.shape)
    check_tensor(_CHUNK, "v", v, dtypes=(q.dtype,), shape=q.shape)
    _check_caches(_CHUNK, k_cache, v_cache)
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
    lib = _lib()
    smem = lib.mx_paged_chunk_prefill_smem(D)
    if smem > _MAX_SMEM:
        raise MXNetError("%s: head_dim %d needs %d bytes of shared memory, "
                         "more than a block has" % (_CHUNK, D, smem))
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out, k_cache, v_cache
    err = lib.mx_paged_chunk_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), block_table.data_ptr(), start.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, K, H, D, bs,
        block_table.shape[1], float(scale), DTYPE_CODE[q.dtype],
        DTYPE_CODE[k_cache.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _CHUNK, err)
    count_launch(_CHUNK)
    return out, k_cache, v_cache
