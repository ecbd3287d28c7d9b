"""Seeded bit-fault injection, parity detection, and scrub/repair for
Compute RAM blocks.

A Compute RAM block is an SRAM array, and SRAM on a real FPGA suffers
soft errors (SEU bit flips in stored rows) and, rarely, whole-block
(hard) faults.  The simulator's default assumption -- every bit read
back is the bit written -- hides both, and the weight-stationary
residency of the fabric scheduler makes a flipped resident weight tile
*persistently* wrong, corrupting every later launch that reads it.

This module provides the three pieces the stack hooks together:

* :class:`FaultModel` -- a seeded, deterministic fault process.  It
  draws per-bit flips at rate ``bit_rate`` each time an execution layer
  offers it a state (an *injection point*: between chained programs,
  before a block launch, per fabric round), and can mark whole blocks
  dead.  All draws come from one ``numpy`` Generator seeded at
  construction, so a given (seed, call sequence) replays exactly --
  the property the fuzzer's differential fault family relies on.
* **2-D parity signatures** -- per-block column parity over rows plus
  row parity over columns (:func:`parity_signature`).  Any odd number
  of flips in some row or column is detected; the smallest undetectable
  pattern is a 4-flip rectangle, vanishingly unlikely at the rates the
  bench gates (<= 1e-4).  Storage is ``rows + cols`` bits per block
  (:func:`parity_bits`), priced by ``core.costmodel.fault_cost``.
* **Scrub + repair** (:func:`scrub_states`) -- verify current state
  against the signature taken at load time; a dirty block is restored
  from its pristine image (the analog of evicting the resident tile and
  re-fetching it from the backing store), with the re-fetch traffic
  charged to the model's counters.

Everything defaults OFF: a ``FaultModel`` with ``bit_rate == 0`` and no
dead blocks is inert (``active`` is False), and every hook treats
``faults=None`` as the pre-fault bit-exact path.

The counterpart of ``repro.core.faults``: the fault process, parity and
scrub are numpy and the reference's own code; only the two engine hooks
are rewritten for the torch engine.  Injection and scrub run on the
host, drawing from the model's Generator in the reference's order, so
the same model arguments give the same flips and counters in both
packages; the corrected state goes back to the device it came from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class FabricFaultError(RuntimeError):
    """A fault the fabric could not mask: a dead block with no spare
    capacity left, or corruption detected with repair disabled.  The
    serve layer catches this to retry / fall back (docs/faults.md)."""


@dataclasses.dataclass
class FaultModel:
    """Deterministic fault process + detection/repair accounting.

    Parameters
    ----------
    bit_rate:
        Per-bit flip probability applied at each injection point.
    dead_blocks:
        Block ids (grid positions) whose contents are garbage every
        launch -- the hard-fault model.  Repair remaps them to spares.
    seed:
        Seeds the private numpy Generator; same seed => same fault
        sequence.
    scrub:
        Enable parity verification + repair at the hooks.  With scrub
        off, injected flips propagate into outputs (the fuzzer's forced
        escape path).
    scrub_every:
        Verify parity every N-th injection point (cadence >= 1).  Flips
        injected between scrubs are still caught at the next scrub
        *before* the state is consumed, because hooks scrub-then-execute.
    heal_after:
        Stop injecting after this many injection *events* (not bits).
        Lets a retry deterministically succeed in serve degradation
        tests.  ``None`` = never heal.
    """

    bit_rate: float = 0.0
    dead_blocks: Tuple[int, ...] = ()
    seed: int = 0
    scrub: bool = True
    scrub_every: int = 1
    heal_after: Optional[int] = None

    # mutable accounting (reset with .reset())
    injected_flips: int = 0
    injection_events: int = 0
    detected: int = 0
    repaired: int = 0
    escaped: int = 0
    refetch_bits: int = 0
    scrub_rows: int = 0
    parity_bits: int = 0
    remaps: int = 0

    def __post_init__(self):
        if self.bit_rate < 0 or self.bit_rate > 1:
            raise ValueError(f"bit_rate must be in [0, 1]: {self.bit_rate}")
        if self.scrub_every < 1:
            raise ValueError(f"scrub_every must be >= 1: {self.scrub_every}")
        self.dead_blocks = tuple(sorted(set(int(b) for b in self.dead_blocks)))
        self._rng = np.random.default_rng(self.seed)

    # -- process ----------------------------------------------------------
    @property
    def active(self) -> bool:
        """True when the model can actually perturb an execution."""
        return self.bit_rate > 0 or bool(self.dead_blocks)

    @property
    def healed(self) -> bool:
        return (self.heal_after is not None
                and self.injection_events >= self.heal_after)

    def flip_mask(self, shape) -> np.ndarray:
        """Draw a boolean flip mask for one injection point.

        Always advances the RNG by one draw (so scrub on/off replays the
        same flip sequence); returns an all-False mask once healed.
        """
        was_healed = self.healed      # before counting THIS event:
        mask = self._rng.random(shape) < self.bit_rate
        self.injection_events += 1    # heal_after=N injects events 1..N
        if was_healed or self.bit_rate <= 0:
            return np.zeros(shape, np.bool_)
        self.injected_flips += int(mask.sum())
        return mask

    def should_scrub(self, point: int) -> bool:
        """Whether injection point ``point`` (0-based) falls on the
        scrub cadence."""
        return self.scrub and point % self.scrub_every == 0

    # -- accounting -------------------------------------------------------
    def reset(self) -> None:
        for f in ("injected_flips", "injection_events", "detected",
                  "repaired", "escaped", "refetch_bits", "scrub_rows",
                  "parity_bits", "remaps"):
            setattr(self, f, 0)
        self._rng = np.random.default_rng(self.seed)

    def stats(self) -> dict:
        return {
            "bit_rate": self.bit_rate,
            "dead_blocks": list(self.dead_blocks),
            "scrub": self.scrub,
            "scrub_every": self.scrub_every,
            "injected_flips": self.injected_flips,
            "injection_events": self.injection_events,
            "detected": self.detected,
            "repaired": self.repaired,
            "escaped": self.escaped,
            "refetch_bits": self.refetch_bits,
            "scrub_rows": self.scrub_rows,
            "parity_bits": self.parity_bits,
            "remaps": self.remaps,
        }


# ---------------------------------------------------------------------------
# 2-D parity signatures
# ---------------------------------------------------------------------------
def parity_bits(rows: int, cols: int) -> int:
    """Parity storage per block: one column-parity word (``cols`` bits,
    XOR over rows) + one row-parity word (``rows`` bits, XOR over
    columns)."""
    return rows + cols


def parity_signature(arrays: np.ndarray):
    """2-D parity of a block batch ``(blocks, rows, cols)`` (bool).

    Returns ``(col_parity (blocks, cols), row_parity (blocks, rows))``.
    """
    a = np.asarray(arrays, np.bool_)
    return (np.logical_xor.reduce(a, axis=-2),
            np.logical_xor.reduce(a, axis=-1))


def dirty_blocks(arrays: np.ndarray, signature) -> np.ndarray:
    """Blocks whose current parity disagrees with ``signature``.

    Returns a ``(blocks,)`` bool mask.  A block is dirty when *any* of
    its column- or row-parity bits mismatch.
    """
    col, row = parity_signature(arrays)
    ref_col, ref_row = signature
    return (np.any(col != ref_col, axis=-1)
            | np.any(row != ref_row, axis=-1))


def scrub_states(arrays: np.ndarray, pristine: np.ndarray, signature,
                 fm: FaultModel) -> np.ndarray:
    """Parity-verify ``arrays`` and restore dirty blocks from
    ``pristine`` (the load-time image == re-fetch from backing store).

    Charges detection/repair/re-fetch to ``fm``'s counters and returns
    the repaired batch.  A scrub *reads* every row of every block it
    verifies (the cost model prices that), but only dirty blocks pay
    re-fetch traffic.
    """
    blocks, rows, cols = arrays.shape
    fm.scrub_rows += blocks * rows
    dirty = dirty_blocks(arrays, signature)
    n_dirty = int(dirty.sum())
    if n_dirty:
        fm.detected += n_dirty
        fm.repaired += n_dirty
        fm.refetch_bits += n_dirty * rows * cols
        arrays = np.where(dirty[:, None, None], pristine, arrays)
    return arrays


# ---------------------------------------------------------------------------
# Engine-level protected execution (imported lazily by core.engine)
# ---------------------------------------------------------------------------
def inject(arrays: np.ndarray, fm: FaultModel,
           dead_slots=None) -> np.ndarray:
    """One injection point over a block batch: bit flips + dead blocks.

    ``dead_slots`` names the batch indices that read back garbage; the
    default ``None`` uses ``fm.dead_blocks`` directly (the engine-level
    convention, where batch index == block id).  The fabric passes an
    explicit (usually empty) list because grid block ids map to launch
    *slots* there, and dead blocks are handled by
    :func:`repro.pim.fabric.repair_program` before any launch.
    """
    was_healed = fm.healed            # flip_mask counts this event
    mask = fm.flip_mask(arrays.shape)
    out = np.logical_xor(arrays, mask)
    dead = fm.dead_blocks if dead_slots is None else dead_slots
    if dead and not was_healed:
        blocks, rows, cols = arrays.shape
        for b in dead:
            if 0 <= b < blocks:
                # a dead block reads back seeded garbage, not zeros --
                # zeros could masquerade as a valid cleared tile
                out[b] = fm._rng.random((rows, cols)) < 0.5
                fm.injected_flips += int(np.sum(out[b] != arrays[b]))
    return out


def apply_block_faults(program, states, fm: FaultModel, *,
                       executor: str = "compiled", packed=None):
    """Faulted :func:`repro_torch.core.engine.execute_blocks`.

    Load-time parity is taken over the incoming row-states (copied to
    the host); flips (and dead-block garbage) are injected there
    *before* lowering, so the packed and bool interiors see identical
    corruption; a scrub on the model's cadence detects dirty blocks by
    parity and restores them from the pristine image; the array goes
    back to the states' device before dispatching to the normal
    executor.
    """
    from . import engine  # local import: engine lazily imports us too

    device = states.array.device
    pristine = states.array.cpu().numpy()
    blocks, rows, cols = pristine.shape
    fm.parity_bits = max(fm.parity_bits, blocks * parity_bits(rows, cols))
    sig = parity_signature(pristine)
    arrays = inject(pristine.copy(), fm)
    if fm.should_scrub(fm.injection_events - 1):
        arrays = scrub_states(arrays, pristine, sig, fm)
    states = states._replace(array=torch.from_numpy(arrays).to(device))
    return engine.execute_blocks(program, states, executor, packed=packed)


def apply_chain_faults(programs, state, fm: FaultModel, *, cse=None):
    """Faulted :func:`repro_torch.core.engine.run_chain`: flips are
    injected between chained programs, so the fused chain gives way to
    a sequential per-program replay (each leg still compiled+cached).
    The state is treated as a 1-block batch for parity purposes.
    """
    from . import engine

    programs = tuple(programs)
    device = state.array.device
    for point, prog in enumerate(programs):
        pristine = state.array.cpu().numpy()[None]
        rows, cols = pristine.shape[1:]
        fm.parity_bits = max(fm.parity_bits, parity_bits(rows, cols))
        sig = parity_signature(pristine)
        arrays = inject(pristine.copy(), fm)
        if fm.should_scrub(fm.injection_events - 1):
            arrays = scrub_states(arrays, pristine, sig, fm)
        state = state._replace(array=torch.from_numpy(arrays[0]).to(device))
        state = engine.run(prog, state, "compiled", packed=None)
    return state
