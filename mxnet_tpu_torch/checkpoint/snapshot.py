"""Full training-state capture and restore.

Counterpart of ``mxnet_tpu/checkpoint/snapshot.py``, writing and reading
the same files.  ``capture(module)`` reads every piece of live training
state at a step boundary: the parameters and auxiliary states, the
optimizer states (a bf16 weight's f32 master among them), the 2-bit
error-feedback residuals (from whichever owner holds them now: the
fused fit step's flat buffers, the bucketed kvstore's, or the store's
per-(key, stream) dict), the loss scaler's triple, the random streams,
the lr-scheduler position and update counts, epoch and step.  It issues
every device-to-host copy at once (into pinned host buffers, which
PyTorch's host allocator caches) and waits once: that wait is the only
thing the training thread pays, and since the next step is enqueued
after it, nothing the training goes on to do can reach the snapshot.
Serialization and IO run wherever the caller runs ``write_checkpoint``
(the async writer's thread, normally).

State keys are parameter names whatever key scheme the live updater
uses (the kvstore's names or the local updater's indices), as
``Module.save/load_optimizer_states`` translate them, so a checkpoint
taken on one path resumes on the other.

Files of checkpoint ``<prefix>``, tag ``<t>`` (``%04d``):

* ``<prefix>-symbol.json``   -- shared; the symbol file
* ``<prefix>-<t>.params``    -- the ``arg:``/``aux:`` parameter file
  (``Module.load`` and ``model.load_checkpoint`` read it)
* ``<prefix>-<t>.states``    -- the name-keyed optimizer-state pickle
* ``<prefix>-<t>.extra``     -- pickle: residuals, the host random
  stream (and the port's generators under ``torch_rng``), the
  lr-scheduler, update counts, the loss scaler
* ``<prefix>-<t>.ckpt.json`` -- the manifest (commit point)

The pickles are written and read through ``pickle_compat``, so either
package restores the other's checkpoint.  A restore into a live module
writes the weights, states, residuals and scaler into the tensors the
module already holds (``copy_``), so a captured fit step keeps reading
them.
"""
from __future__ import annotations

import copy
import logging
import os
import time
import zlib

import numpy as _np
import torch

from . import manifest as _mf
from .. import pickle_compat
from ..ndarray.ndarray import NDArray
from ..serialization import host_numpy, save_ndarray_file
from ..telemetry import REGISTRY

__all__ = ["capture", "capture_params", "write_checkpoint", "load",
           "restore"]

RESTORE_MS = REGISTRY.histogram(
    "checkpoint_restore_ms",
    "wall time of a full training-state restore (read + verify + place)",
    unit="ms")


def _map_state(fn, state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    return fn(state)


class _HostCopy:
    """Device-to-host copies issued back to back on each device's
    current stream, into pinned buffers (pageable with ``pinned``
    False), then one wait."""

    def __init__(self, pinned=True):
        self.pinned = pinned
        self._devices = set()

    def __call__(self, t):
        if isinstance(t, NDArray):
            t = t._data
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pinned)
        out.copy_(t, non_blocking=self.pinned)
        self._devices.add(t.device)
        return out

    def wait(self):
        for dev in self._devices:
            torch.cuda.current_stream(dev).synchronize()


def _plain_kvstore(module):
    """The module's single-process store (its weights and residuals are
    state this checkpointer captures), or None."""
    from ..kvstore import KVStore
    kv = getattr(module, "_kvstore", None)
    return kv if isinstance(kv, KVStore) else None


def _capture_residuals(module, host):
    """Error-feedback residuals as ``{(key, stream): host tensor}``,
    read from whichever owner holds them without changing the owner: a
    checkpoint must not change what the next step computes."""
    out = {}
    ff = getattr(module, "_fused_fit", None)
    if ff is not None and ff._res_live:
        for layout, flat in zip(ff._buckets, ff._res_flat):
            for name, off, size, shape in layout:
                out[(name, 0)] = host(flat[off:off + size].view(shape))
    kv = _plain_kvstore(module)
    if kv is not None:
        eng = kv._engine
        if eng is not None:
            for keys_tuple, rec in eng._flat_res.items():
                for d, flat in enumerate(rec["res"]):
                    for key, (off, size, shape) in zip(keys_tuple,
                                                       rec["layout"]):
                        if (key, d) not in out:
                            out[(key, d)] = host(
                                flat[off:off + size].view(shape))
        for (key, d), arr in kv._compression_residuals.items():
            if (key, d) not in out:
                out[(key, d)] = host(arr)
    return out


def _capture_optimizer(module, host):
    """(name-keyed states, extra pieces) from the live updater, or
    (None, {}) when the module has no updater of the port's."""
    from ..optimizer import Updater
    if not getattr(module, "optimizer_initialized", False):
        return None, {}
    updater = module._live_updater()
    if not isinstance(updater, Updater):
        return None, {}
    name_to_live, _ = module._opt_state_key_maps()
    live_to_name = {lk: n for n, lk in name_to_live.items()}
    states = {live_to_name.get(k, k): _map_state(host, v)
              for k, v in updater.states.items()}
    optimizer = updater.optimizer
    counts = {live_to_name.get(k, k): int(v)
              for k, v in optimizer._index_update_count.items()}
    extra = {"index_update_count": counts,
             "num_update": int(optimizer.num_update),
             "lr_scheduler": copy.deepcopy(optimizer.lr_scheduler)}
    return states, extra


def capture(module, epoch=None, step=None, include_optimizer=True,
            pinned=True):
    """Snapshot the complete training state of ``module`` as host
    tensors.  Runs on the training thread and blocks only for the
    device-to-host copies (no IO, no serialization, no graph launch).
    ``pinned=False`` copies into pageable memory instead (measured
    against the pinned copy in ``chip_smoke.py``'s checkpoint phase)."""
    from .. import random as _random
    kv = _plain_kvstore(module)
    if kv is not None:
        kv._flush_pending()        # pending buckets touch weights, states
    host = _HostCopy(pinned)
    exe = module._exec_group._exec
    state = {
        "symbol_json": module.symbol.tojson(),
        "args": {n: host(exe.arg_dict[n]) for n in module._param_names},
        "auxs": {n: host(exe.aux_dict[n]) for n in module._aux_names},
        "epoch": epoch, "step": step, "states": None,
    }
    extra = {}
    if include_optimizer:
        state["states"], opt_extra = _capture_optimizer(module, host)
        extra.update(opt_extra)
    residuals = _capture_residuals(module, host)
    host.wait()
    if residuals:
        extra["residuals"] = residuals
    scaler = getattr(module, "_loss_scaler", None)
    if scaler is not None:
        # the copies above were the sync: reading the triple is free
        extra["loss_scaler"] = scaler.state_dict()
    rng = _random.get_state()
    state["rng"] = {"seed": rng["seed"], "key": None}
    extra["host_rng"] = rng["host"]
    extra["torch_rng"] = rng["torch"]
    state["extra"] = extra
    return state


def capture_params(arg_params, aux_params=None, symbol=None, epoch=None,
                   step=None):
    """A parameters-only snapshot from dicts (``do_checkpoint``'s form,
    no module needed)."""
    host = _HostCopy(pinned=False)
    return {
        "symbol_json": symbol.tojson() if symbol is not None else None,
        "args": {k: host(v) if isinstance(v, (NDArray, torch.Tensor))
                 else _np.asarray(v) for k, v in (arg_params or {}).items()},
        "auxs": {k: host(v) if isinstance(v, (NDArray, torch.Tensor))
                 else _np.asarray(v) for k, v in (aux_params or {}).items()},
        "states": None, "extra": {}, "epoch": epoch, "step": step,
        "rng": None,
    }


# ----------------------------------------------------------------------
# serialization and the crash-safe write (on the writer's thread)
# ----------------------------------------------------------------------
def _tensor_record(value):
    raw, bf16 = host_numpy(value)
    raw = _np.ascontiguousarray(raw)
    return {"crc32": zlib.crc32(raw) & 0xFFFFFFFF, "bytes": raw.nbytes,
            "shape": list(raw.shape),
            "dtype": "bfloat16" if bf16 else str(raw.dtype)}


def _to_numpy(v):
    """A host tensor as numpy for the extra pickle (the JAX package's
    residuals are numpy); bf16 keeps its type as an NDArray."""
    if isinstance(v, torch.Tensor):
        return NDArray(v) if v.dtype == torch.bfloat16 else v.numpy()
    return v


def write_checkpoint(state, prefix, tag):
    """Serialize ``state`` and publish checkpoint ``tag`` atomically.
    Returns the committed manifest (bytes written under
    ``total_bytes``)."""
    base_dir = os.path.dirname(prefix)
    files, tensors, total = {}, {}, 0

    if state.get("symbol_json"):
        sym_path = "%s-symbol.json" % prefix
        blob = state["symbol_json"].encode()
        try:                    # shared file: skip the rewrite when its
            with open(sym_path, "rb") as f:        # content is unchanged
                unchanged = f.read() == blob
        except OSError:
            unchanged = False
        if unchanged:
            nbytes = len(blob)
            crc = zlib.crc32(blob) & 0xFFFFFFFF
        else:
            nbytes, crc = _mf.atomic_write(sym_path, blob)
        files["symbol"] = {"file": os.path.relpath(sym_path,
                                                   base_dir or "."),
                           "bytes": nbytes, "crc32": crc}

    save_dict = {"arg:%s" % k: v for k, v in state["args"].items()}
    save_dict.update({"aux:%s" % k: v for k, v in state["auxs"].items()})
    for key, v in save_dict.items():
        tensors[key] = _tensor_record(v)
    params_path = "%s-%s.params" % (prefix, _mf.tag_str(tag))
    nbytes, crc = _mf.atomic_write(
        params_path, writer=lambda tmp: save_ndarray_file(tmp, save_dict))
    files["params"] = {"file": os.path.basename(params_path),
                       "bytes": nbytes, "crc32": crc}
    total += nbytes

    if state.get("states") is not None:
        states = {k: _map_state(NDArray, v)
                  for k, v in state["states"].items()}
        states_path = "%s-%s.states" % (prefix, _mf.tag_str(tag))

        def dump_states(tmp):
            with open(tmp, "wb") as f:
                pickle_compat.dump(states, f)
        nbytes, crc = _mf.atomic_write(states_path, writer=dump_states)
        files["states"] = {"file": os.path.basename(states_path),
                           "bytes": nbytes, "crc32": crc}
        total += nbytes

    extra = dict(state.get("extra") or {})
    if extra.get("residuals"):
        extra["residuals"] = {k: _to_numpy(v)
                              for k, v in extra["residuals"].items()}
    if any(v is not None for v in extra.values()):
        blob = pickle_compat.dumps(extra)
        extra_path = "%s-%s.extra" % (prefix, _mf.tag_str(tag))
        nbytes, crc = _mf.atomic_write(extra_path, blob)
        files["extra"] = {"file": os.path.basename(extra_path),
                          "bytes": nbytes, "crc32": crc}
        total += nbytes

    meta = {"epoch": state.get("epoch"), "step": state.get("step"),
            "rng": state.get("rng"), "time": time.time(),
            "total_bytes": total, "library": "mxnet_tpu_torch"}
    return _mf.write_manifest(prefix, tag, files, tensors, meta)


# ----------------------------------------------------------------------
# load / restore
# ----------------------------------------------------------------------
def _resolve(prefix, tag):
    if tag is None:
        man = _mf.latest(prefix)
        if man is None:
            raise IOError("no intact checkpoint found for prefix %r"
                          % prefix)
        return man
    man = _mf.read_manifest(prefix, tag)
    if man is None or not _mf.validate(prefix, man):
        raise IOError("checkpoint %s is missing or corrupt"
                      % _mf.manifest_path(prefix, tag))
    return man


def _verify_tensors(manifest, arg_params, aux_params, prefix):
    for kind, params in (("arg", arg_params), ("aux", aux_params)):
        for name, v in params.items():
            rec = manifest.get("tensors", {}).get("%s:%s" % (kind, name))
            if rec is None:
                continue
            if _tensor_record(v)["crc32"] != rec["crc32"]:
                raise IOError("checkpoint %s: tensor %s:%s fails its "
                              "manifest checksum" % (prefix, kind, name))


def load(prefix, tag=None, verify=True):
    """Checkpoint content: ``(symbol or None, arg_params, aux_params,
    manifest)``, the parameters as NDArrays on the CPU.  ``tag=None``
    takes the newest intact checkpoint (``manifest.latest``); per-tensor
    checksums are checked after the parse unless ``verify=False``."""
    from .. import model as _model
    man = _resolve(prefix, tag)
    if int(man.get("world", 1) or 1) > 1:
        raise IOError("checkpoint %s is sharded over several processes: "
                      "sharded checkpoints come with the multi-GPU slice "
                      "of the PyTorch port (ROADMAP A.8)"
                      % _mf.manifest_path(prefix, man["tag"]))
    arg_params, aux_params = _model.load_params(prefix, man["tag"])
    if verify:
        _verify_tensors(man, arg_params, aux_params, prefix)
    symbol = None
    if "symbol" in man.get("files", {}):
        from .. import symbol as _sym
        symbol = _sym.load("%s-symbol.json" % prefix)
    return symbol, arg_params, aux_params, man


def _load_extra(prefix, man):
    rec = man.get("files", {}).get("extra")
    if rec is None:
        return {}
    with open(os.path.join(os.path.dirname(prefix), rec["file"]), "rb") as f:
        return pickle_compat.load(f)


def _as_tensor(v):
    return v._data if isinstance(v, NDArray) else torch.from_numpy(
        _np.ascontiguousarray(v))


def _restore_residuals(module, residuals):
    """Seed the restored error-feedback residuals where either path
    finds them: the store's per-(key, stream) dict.  A live fused step
    drops what its flat buffers hold (without spilling it: the restored
    values must win) and copies the dict into the same buffers at its
    next step."""
    kv = _plain_kvstore(module)
    if kv is None or kv._compression is None:
        logging.warning(
            "checkpoint.restore: the checkpoint carries %d error-feedback "
            "residuals but this module has no compression to seed them "
            "into", len(residuals))
        return
    kv._sync_engine()              # flush, and end the engine's ownership
    for (key, dev), arr in residuals.items():
        where = kv._store[key]._data.device if key in kv._store else "cpu"
        kv._compression_residuals[(key, dev)] = NDArray(
            _as_tensor(arr).to(where, torch.float32, copy=True))
    ff = getattr(module, "_fused_fit", None)
    if ff is not None:
        ff._res_live = False


def restore(module, prefix, tag=None, load_optimizer=True, verify=True,
            logger=None):
    """Restore the complete training state of ``module`` from the newest
    intact checkpoint (or ``tag``).  Returns the manifest (epoch and
    step under ``manifest["epoch"]`` and ``["step"]``).

    The module should be bound with its optimizer initialized for a
    full restore; a module that is not bound gets the parameters (set
    at ``bind``) and the states (loaded at ``init_optimizer``), and the
    optimizer's position is skipped with a warning."""
    from .. import random as _random
    from ..fused_update import DynamicLossScaler
    log = logger or logging
    t0 = time.perf_counter()
    _, arg_params, aux_params, man = load(prefix, tag, verify=verify)
    tag = man["tag"]

    if getattr(module, "binded", False):
        module.set_params(arg_params, aux_params, allow_missing=False,
                          force_init=True, allow_extra=True)
        kv = _plain_kvstore(module)
        if kv is not None and module._update_on_kvstore:
            # the store's weights are what the updates read: written in
            # place, as the captured step holds them
            with torch.no_grad():
                for name, v in arg_params.items():
                    if name in kv._store:
                        kv._store[name]._data.copy_(v._data)
    else:
        module._preloaded_params = (arg_params, aux_params)
        module.params_initialized = True

    extra = _load_extra(prefix, man)
    states_rec = man.get("files", {}).get("states")
    states_path = os.path.join(os.path.dirname(prefix), states_rec["file"]) \
        if states_rec else None
    if load_optimizer and states_path is not None:
        if getattr(module, "optimizer_initialized", False):
            module.load_optimizer_states(states_path)
            optimizer = module._optimizer
            name_to_live, _ = module._opt_state_key_maps()
            for name, n in (extra.get("index_update_count") or {}).items():
                optimizer._index_update_count[
                    name_to_live.get(name, name)] = int(n)
            optimizer.num_update = max(
                optimizer.num_update, int(extra.get("num_update", 0) or 0))
            if extra.get("lr_scheduler") is not None:
                optimizer.lr_scheduler = extra["lr_scheduler"]
        else:
            module._preload_opt_states = states_path
            log.warning("checkpoint.restore: optimizer not initialized; "
                        "states will preload at init_optimizer, but the "
                        "lr-scheduler position and update counts are only "
                        "restored on an initialized module")

    if extra.get("residuals"):
        _restore_residuals(module, extra["residuals"])

    scaler_state = extra.get("loss_scaler")
    if scaler_state:
        scaler = getattr(module, "_loss_scaler", None)
        if scaler is not None:
            scaler.load_state_dict(scaler_state)
        else:
            # the fused step is not built yet: it takes this scaler
            module._loss_scaler = DynamicLossScaler.from_state(scaler_state)

    rng = man.get("rng")
    if rng is not None:
        _random.set_state({"seed": rng.get("seed"),
                           "host": extra.get("host_rng"),
                           "torch": extra.get("torch_rng")})

    RESTORE_MS.observe((time.perf_counter() - t0) * 1e3)
    return man
