"""SoftHier executable model — functional BSP executor (paper §2.1, §2.3).

Port of `repro/sim/softhier.py` (numpy; the port's `core.ir`). It models
the accelerator on the host, so it runs no kernel and needs no card.

Executes a BSP `Program` over a tile grid with real data: per-tile L1 buffers
(numpy arrays, one per declared slot), HBM held as whole matrices (the
channel-level preload/packing path is exercised separately by
`repro_torch.core.layout.pack_preload`). The executor implements strict BSP
semantics: within a superstep, MMADs read the L1 state left by previous
barriers; communication issued in a superstep becomes visible at its barrier.

This is the 'functional evaluation' half of SoftHier; the performance half
(cycle estimation with HBM-channel and NoC contention) is `repro_torch.sim.perf`.
Numerics run in float32 shadow precision regardless of the deployment dtype
declared on the buffers (the declared dtype sizes the L1-capacity check and
the byte counts in the cost model).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.ir import (DMAOp, MMADOp, MulticastOp, P2POp, Program,
                                 ReduceOp)


@dataclasses.dataclass
class SimResult:
    c: np.ndarray
    supersteps: int
    op_counts: Dict[str, int]


class FunctionalSim:
    """Functional execution of one GEMM program: C = A @ B."""

    def __init__(self, prog: Program, a: np.ndarray, b: np.ndarray):
        self.prog = prog
        m, n, k = prog.shape
        if a.shape != (m, k) or b.shape != (k, n):
            raise ValueError(f"operand shapes {a.shape} {b.shape} do not match "
                             f"program GEMM {prog.shape}")
        self.a = a.astype(np.float32)
        self.b = b.astype(np.float32)
        self.c = np.zeros((m, n), dtype=np.float32)
        self.tm, self.tn, self.tk = prog.tile_shape
        # l1[tile][buf] = list of per-slot arrays (lazily allocated)
        self.l1: Dict[Tuple[int, int], Dict[str, list]] = {}

    # -- L1 access -----------------------------------------------------------

    def _buf(self, tile, name, slot) -> Optional[np.ndarray]:
        return self.l1.get(tile, {}).get(name, {}).get(slot)

    def _set(self, tile, name, slot, value: np.ndarray) -> None:
        decl = self.prog.buffers[name]
        if not (0 <= slot < decl.slots):
            raise IndexError(f"slot {slot} out of range for buffer {name!r} "
                             f"({decl.slots} slots)")
        self.l1.setdefault(tile, {}).setdefault(name, {})[slot] = value

    # -- HBM tile access -------------------------------------------------------

    def _hbm_read(self, matrix: str, tile_coord) -> np.ndarray:
        ti, tj = tile_coord
        if matrix == "A":
            return self.a[ti * self.tm:(ti + 1) * self.tm,
                          tj * self.tk:(tj + 1) * self.tk].copy()
        if matrix == "B":
            return self.b[ti * self.tk:(ti + 1) * self.tk,
                          tj * self.tn:(tj + 1) * self.tn].copy()
        return self.c[ti * self.tm:(ti + 1) * self.tm,
                      tj * self.tn:(tj + 1) * self.tn].copy()

    def _hbm_write(self, matrix: str, tile_coord, value, accumulate: bool) -> None:
        if matrix != "C":
            raise ValueError("only C may be stored")
        ti, tj = tile_coord
        view = self.c[ti * self.tm:(ti + 1) * self.tm,
                      tj * self.tn:(tj + 1) * self.tn]
        if accumulate:
            view += value
        else:
            view[...] = value

    # -- execution -------------------------------------------------------------

    def run(self) -> SimResult:
        for step in self.prog.supersteps:
            # compute phase reads pre-barrier state
            for op in step.compute:
                a = self._buf(op.tile, op.a_buf, op.a_slot)
                b = self._buf(op.tile, op.b_buf, op.b_slot)
                if a is None or b is None:
                    raise RuntimeError(
                        f"MMAD on {op.tile} reads empty buffer "
                        f"{op.a_buf}[{op.a_slot}]/{op.b_buf}[{op.b_slot}] "
                        f"in superstep {step.label!r}")
                acc = self._buf(op.tile, op.acc_buf, op.acc_slot)
                prod = a @ b
                if op.init or acc is None:
                    self._set(op.tile, op.acc_buf, op.acc_slot, prod)
                else:
                    acc += prod
            # communication. DMA loads apply first (fabric multicasts may
            # chain off an owner's same-superstep DMA, `after_dma`); NoC ops
            # then read post-DMA state; all other effects land at the barrier.
            for op in step.comm:
                if isinstance(op, DMAOp) and op.kind == "load":
                    self._set(op.tile, op.buf, op.slot,
                              self._hbm_read(op.matrix, op.tile_coord))
            effects = []
            for op in step.comm:
                if isinstance(op, DMAOp):
                    if op.kind == "load":
                        pass  # applied above
                    else:
                        src = self._buf(op.tile, op.buf, op.slot)
                        if src is None:
                            raise RuntimeError(f"store from empty buffer on {op.tile} "
                                               f"({op.buf}[{op.slot}])")
                        effects.append(("hbm", op.matrix, op.tile_coord,
                                        src.copy(), op.accumulate))
                elif isinstance(op, MulticastOp):
                    src = self._buf(op.src, op.buf, op.slot)
                    if src is None:
                        raise RuntimeError(f"multicast from empty buffer on {op.src} "
                                           f"({op.buf}[{op.slot}]) step {step.label!r}")
                    dst_buf = op.dst_buf or op.buf
                    dst_slot = op.slot if op.dst_slot is None else op.dst_slot
                    for member in op.group.members(self.prog.grid):
                        effects.append(("set", member, dst_buf, dst_slot, src.copy()))
                elif isinstance(op, ReduceOp):
                    total = None
                    for member in op.group.members(self.prog.grid):
                        v = self._buf(member, op.buf, op.slot)
                        if v is None:
                            raise RuntimeError(f"reduce reads empty buffer on {member}")
                        total = v.copy() if total is None else total + v
                    dst_buf = op.dst_buf or op.buf
                    effects.append(("set", op.dst, dst_buf, op.slot, total))
                elif isinstance(op, P2POp):
                    src = self._buf(op.src, op.buf, op.slot)
                    if src is None:
                        raise RuntimeError(f"p2p from empty buffer on {op.src} "
                                           f"({op.buf}[{op.slot}]) step {step.label!r}")
                    dst_slot = op.slot if op.dst_slot is None else op.dst_slot
                    dst_buf = op.dst_buf or op.buf
                    effects.append(("set", op.dst, dst_buf, dst_slot, src.copy()))
                else:
                    raise TypeError(f"unknown comm op {type(op)}")
            # barrier: apply effects
            for eff in effects:
                if eff[0] == "set":
                    _, tile, buf, slot, value = eff
                    self._set(tile, buf, slot, value)
                else:
                    _, matrix, coord, value, acc = eff
                    self._hbm_write(matrix, coord, value, acc)
        return SimResult(self.c, len(self.prog.supersteps), self.prog.op_counts())


def run_gemm(prog: Program, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Convenience: execute the program and return C."""
    return FunctionalSim(prog, a, b).run().c


def verify_gemm(prog: Program, a: np.ndarray, b: np.ndarray,
                rtol: float = 1e-4, atol: float = 1e-4) -> None:
    """The paper's 'compare results against reference outputs' workflow stage."""
    c = run_gemm(prog, a, b)
    ref = a.astype(np.float32) @ b.astype(np.float32)
    np.testing.assert_allclose(c, ref, rtol=rtol, atol=atol)
