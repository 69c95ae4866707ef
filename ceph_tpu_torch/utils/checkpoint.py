"""Checkpoint/resume for long placement sweeps.

The port's copy of ``ceph_tpu/utils/checkpoint.py`` (ref: the
reference's resumability machinery, SURVEY.md §5.4: the PG log and the
mon store let interrupted work resume). A 100M-PG sweep's driver state
is tiny: the crushmap (as compiler text), the sweep config, the PG
cursor and the partial count vector, so one JSON file with an atomic
rename gives a crash-safe resume. Deterministic re-derivation does the
rest: CRUSH is a pure function, so resuming from the cursor reproduces
exactly the counts an uninterrupted run would have produced.

The sweep is the port's ``Mapper.sweep``, chunk by chunk, on the
Mapper's device (on the card each chunk is ``crush_straw2`` launches);
only the per-device counts come back to the host. The saved file equals
the reference's for the same map and arguments.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SweepState:
    """Resumable aggregated-sweep progress."""

    crushmap_text: str
    rule: int
    num_rep: int
    n_total: int
    cursor: int = 0                      # PGs fully aggregated so far
    bad: int = 0
    counts: np.ndarray = field(default_factory=lambda: np.zeros(0))
    weights_digest: str = ""             # device reweights affect placement

    def save(self, path: str) -> None:
        """ONE file, one atomic rename: counts and cursor must move
        together or a crash between two renames double-counts a chunk
        on resume."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"crushmap_text": self.crushmap_text,
                       "rule": self.rule, "num_rep": self.num_rep,
                       "n_total": self.n_total, "cursor": self.cursor,
                       "bad": self.bad,
                       "weights_digest": self.weights_digest,
                       "counts": np.asarray(self.counts,
                                            dtype=np.int64).tolist()}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "SweepState | None":
        if not os.path.exists(path):
            return None
        with open(path) as f:
            d = json.load(f)
        return cls(crushmap_text=d["crushmap_text"], rule=d["rule"],
                   num_rep=d["num_rep"], n_total=d["n_total"],
                   cursor=d["cursor"], bad=d["bad"],
                   counts=np.asarray(d["counts"], dtype=np.int64),
                   weights_digest=d.get("weights_digest", ""))


def resumable_sweep(crush_map, rule: int, n: int, num_rep: int,
                    ckpt_path: str, chunk: int = 1 << 22,
                    mapper=None, max_chunks: int | None = None,
                    device=None):
    """Aggregated sweep of n PGs with checkpoint-per-chunk.

    Restarting with the same ckpt_path resumes at the saved cursor; the
    crushmap text in the checkpoint must match (a changed map invalidates
    the partial counts — placement is a pure function of the map).
    max_chunks limits work per call (None = run to completion).
    ``device`` is the Mapper's when none is given (CUDA unless "cpu").
    Returns (state, done).
    """
    import hashlib

    from ceph_tpu_torch.crush.compiler import decompile_crushmap
    from ceph_tpu_torch.crush.mapper import Mapper
    from ceph_tpu_torch.ec.torch_plugin import to_host

    text = decompile_crushmap(crush_map)
    if mapper is None:
        mapper = Mapper(crush_map, device=device)
    # reweights (is_out vector) change placement without changing the
    # crushmap text — they are part of the sweep's identity
    digest = hashlib.sha256(
        np.asarray(mapper.device_weights, dtype=np.int64).tobytes()
    ).hexdigest()
    state = SweepState.load(ckpt_path)
    if state is not None:
        if (state.crushmap_text != text or state.rule != rule or
                state.num_rep != num_rep or state.n_total != n or
                state.weights_digest != digest):
            raise ValueError(
                f"checkpoint {ckpt_path} belongs to a different sweep "
                f"(map/rule/num_rep/n/reweights changed); delete it to "
                f"restart")
    else:
        state = SweepState(crushmap_text=text, rule=rule,
                           num_rep=num_rep, n_total=n,
                           weights_digest=digest)
    if state.counts.size == 0:
        state.counts = np.zeros(mapper.packed.max_devices, dtype=np.int64)
    chunks_run = 0
    while state.cursor < n:
        if max_chunks is not None and chunks_run >= max_chunks:
            break
        step = min(chunk, n - state.cursor)
        counts, bad = mapper.sweep(rule, state.cursor, step, num_rep)
        state.counts = state.counts + to_host(counts).astype(np.int64)
        state.bad += int(to_host(bad))
        state.cursor += step
        state.save(ckpt_path)
        chunks_run += 1
    return state, state.cursor >= n
