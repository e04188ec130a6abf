"""Fault-tolerant checkpointing.

Port of `repro/ckpt/manager.py`. Atomic: a checkpoint is written to
`step_N.tmp/` and renamed to `step_N/` only when complete, so a crash
mid-write can never corrupt the latest checkpoint. A state is any nesting
of tensors, `nn.Module`s (saved as their `state_dict`), mappings, tuples,
lists and NamedTuples (the trainer's is (model, AdamW state, compress
state or None)); it flattens to named tensors in a fixed order.

numpy's npz format cannot hold bfloat16 or fp8: such tensors are stored as
integer views of the same width, and the manifest records each tensor's
dtype, as the reference does for its ml_dtypes arrays.

Restore loads into the tensors of the state it is given, in place, after
checking names and shapes: the trainer's step updates its state in place,
so the live state is the one to overwrite, and no second copy of it is
allocated on the device.

A sharded state (`parallel.sharded`) keeps the file format: `save(...,
shardings=...)` gathers one tensor at a time whole, rank 0 writes it, and
the checkpoint is published (renamed into place) by rank 0 before a
barrier that every rank passes, so a sharded run's checkpoint restores
into an unsharded one and back. The barrier also tells every rank
whether rank 0 could write: if not, every rank raises. `restore(..., shardings=...)` is the
reference's elastic restore: each rank reads the whole tensors and keeps
its own block of each, whatever mesh (and world) wrote them. `shardings`
maps a leaf name (as `flatten` names it) to its `Placement`
(`sharded.state_shardings` builds it for a trainer state); leaves it does
not name are whole on every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_MANIFEST = "manifest.json"
# dtypes npz holds as they are; anything else is stored as an integer view
_NUMPY_DTYPES = {torch.float64, torch.float32, torch.float16, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8,
                 torch.bool}
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def flatten(state: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) leaves of `state` in a fixed order. Module leaves are
    their `state_dict` tensors, which share the parameters' storage."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [(prefix.rstrip("."), state)]
    if isinstance(state, nn.Module):
        return [(prefix + k, v) for k, v in state.state_dict().items()]
    if isinstance(state, dict):
        items = state.items()
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        items = zip(state._fields, state)
    elif isinstance(state, (tuple, list)):
        items = enumerate(state)
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__} at "
                        f"{prefix.rstrip('.') or '<root>'}")
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}{k}.")
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _encode(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` as a numpy array npz can hold. Always a copy: the
    live tensor may be updated in place while an async save writes."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype not in _NUMPY_DTYPES:
        t = t.view(_INT_VIEW[t.element_size()])
    return t.numpy()


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    dtype = getattr(torch, dtype_name)
    return t if t.dtype == dtype else t.view(dtype)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _agree(step: int, err: Optional[Exception], device) -> None:
    """The end of a sharded save on every rank: wait for rank 0's write
    (an all-reduce of its failure flag, in place of a barrier) and raise
    on every rank alike if it failed, so that no rank goes on alone into
    the next step's collectives. Rank 0 raises its own error."""
    import torch.distributed as dist
    failed = err is not None
    if dist.is_initialized() and dist.get_world_size() > 1:
        flag = torch.tensor([int(failed)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        failed = bool(flag.item())
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"rank 0 failed to write checkpoint step {step}")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = True,
             shardings: Optional[Mapping[str, Any]] = None) -> None:
        """Checkpoint `state` as step `step`. With `shardings` (a sharded
        state's placements) this is a collective: every rank gathers each
        sharded tensor in turn, rank 0 alone writes and publishes, and the
        call returns on every rank once the checkpoint is in place (it
        blocks whatever `blocking` says), or raises on every rank if rank 0
        could not write it."""
        # snapshot to host memory synchronously (consistent view), write async
        leaves = flatten(state)
        if shardings is None:
            arrs = [_encode(t) for _, t in leaves]
        else:
            from repro_torch.parallel import sharded
            writer = _rank() == 0
            err: Optional[Exception] = None
            arrs = []
            for name, t in leaves:
                pl = shardings.get(name)
                whole = t if pl is None else sharded.gather_data(t, pl)
                # rank 0 keeps gathering after an error, so that the
                # others are not left waiting in a gather
                if writer and err is None:
                    try:
                        arrs.append(_encode(whole))
                    except Exception as e:
                        err = e
                else:
                    arrs.append(None)
                del whole                  # one whole tensor at a time
            blocking = True
        meta = {"step": step, "n_arrays": len(arrs),
                "names": [n for n, _ in leaves],
                "dtypes": [_dtype_name(t.dtype) for _, t in leaves],
                "extra": extra or {}}

        def write():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, a in enumerate(arrs)})
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        if shardings is not None:
            if writer and err is None:
                try:
                    write()
                except Exception as e:
                    err = e
            _agree(step, err, leaves[0][1].device if leaves else "cpu")
        elif blocking:
            write()
        else:
            self.wait()
            self._async_thread = threading.Thread(target=write, daemon=True)
            self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self) -> None:
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    @torch.no_grad()
    def restore(self, step: int, like: Any,
                shardings: Optional[Mapping[str, Any]] = None) -> Any:
        """Load checkpoint `step` into the tensors of `like`, in place (cast
        to each tensor's dtype and device), and return `like`. With
        `shardings`, a tensor it places receives this rank's block of the
        checkpoint's whole tensor (elastic restore onto any mesh)."""
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            meta = json.load(f)
        leaves = flatten(like)
        if len(leaves) != meta["n_arrays"]:
            raise ValueError(f"checkpoint has {meta['n_arrays']} arrays, "
                             f"expected {len(leaves)}")
        names = [n for n, _ in leaves]
        if names != meta["names"]:
            bad = next(i for i, (a, b) in enumerate(zip(meta["names"], names))
                       if a != b)
            raise ValueError(f"checkpoint holds {meta['names'][bad]!r} where "
                             f"{names[bad]!r} is expected")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            arrs = [_decode(data[f"a{i}"], meta["dtypes"][i])
                    for i in range(meta["n_arrays"])]
        blocks = []
        for (name, want), got in zip(leaves, arrs):
            pl = (shardings or {}).get(name)
            if pl is not None:
                if tuple(got.shape) != tuple(pl.shape):
                    raise ValueError(f"shape mismatch {tuple(got.shape)} vs "
                                     f"{tuple(pl.shape)} at {name}")
                got = got[pl.block()]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"shape mismatch {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)} at {name}")
            blocks.append(got)
        for (_, want), got in zip(leaves, blocks):
            want.copy_(got)
        return like

    def restore_extra(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)["extra"]
