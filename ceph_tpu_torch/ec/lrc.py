"""Locally Repairable Codes: layered erasure coding.

The counterpart of ``ceph_tpu/ec/lrc.py``.

ref: src/erasure-code/lrc/ErasureCodeLrc.{h,cc}. An LRC profile is a
global ``mapping`` string over chunk positions (``D`` = original data,
``_`` = parity) plus ordered ``layers``: each layer is a sub-code over a
subset of positions (``D`` = layer input, ``c`` = layer output, ``_`` =
not in layer). Local layers make single-chunk repair read only the local
group (l chunks) instead of k: that is the whole point of the plugin.

The ``k/m/l`` shorthand generates the documented layout (ref:
doc/rados/operations/erasure-code-lrc.rst): (k+m)/l groups, each group =
one local parity followed by its share of global parities and data.

Each layer is an ``ErasureCodeTorch`` on the plugin's device, so a
batched encode is one ``gf_encode`` kernel launch per layer, with the
chunk scatter between layers done by index assignment on the device.

Provenance: the reference tree was empty during the survey (SURVEY.md
warning), so layer-generation parity with upstream is asserted from the
documented examples, pending byte-level verification.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping, Sequence

import numpy as np

import torch

from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch, to_host
from ceph_tpu_torch.utils import device as devsel
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("ec")

DEFAULT_LAYER_PLUGIN = "technique=reed_sol_van"


class _Layer:
    """One sub-code: positions + an RS plugin sized to the layer."""

    def __init__(self, mapping: str, config: str, device: torch.device):
        self.mapping = mapping
        self.data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
        self.coding_pos = [i for i, ch in enumerate(mapping) if ch == "c"]
        self.positions = sorted(self.data_pos + self.coding_pos)
        prof = ErasureCodeProfile.parse(config or DEFAULT_LAYER_PLUGIN)
        prof["k"] = str(len(self.data_pos))
        prof["m"] = str(len(self.coding_pos))
        prof.setdefault("technique", "reed_sol_van")
        self.code = ErasureCodeTorch(prof, device=device)

    @property
    def k(self) -> int:
        return len(self.data_pos)

    @property
    def m(self) -> int:
        return len(self.coding_pos)


def generate_kml(k: int, m: int, l: int) -> tuple[str, list[list[str]]]:
    """k/m/l -> (mapping, layers) per the documented layout
    (ref: ErasureCodeLrc::parse_kml).

    (k+m) must be a multiple of l; each group of l global chunks gets one
    local parity, so chunk count = k + m + (k+m)/l. Within a group the
    order is [local][globals], globals being parities-first then data —
    reproducing the doc example k=4 m=2 l=3 ->
    mapping ``__DD__DD``, layers ``_cDD_cDD`` + one local ``c`` per group.
    """
    if (k + m) % l:
        raise ValueError(f"k+m={k + m} must be a multiple of l={l}")
    ngroups = (k + m) // l
    if m % ngroups:
        raise ValueError(f"m={m} must spread evenly over {ngroups} groups")
    per_group_m = m // ngroups
    n = (l + 1) * ngroups
    mapping: list[str] = []
    global_layer: list[str] = []
    for _ in range(ngroups):
        mapping.append("_")          # local parity slot
        global_layer.append("_")
        for s in range(l):           # the group's l global chunks
            is_parity = s < per_group_m
            mapping.append("_" if is_parity else "D")
            global_layer.append("c" if is_parity else "D")
    layers = [["".join(global_layer), ""]]
    for g in range(ngroups):
        row = ["_"] * n
        lo = g * (l + 1)
        row[lo] = "c"
        row[lo + 1:lo + 1 + l] = "D" * l
        layers.append(["".join(row), ""])
    return "".join(mapping), layers


class ErasureCodeLrc(ErasureCodeInterface):
    """plugin=lrc  (k=K m=M l=L | mapping=... layers=[[..],..])
    [device=cuda|cpu]"""

    def __init__(self, profile: ErasureCodeProfile | str | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.mapping = ""
        self.layers: list[_Layer] = []
        self._device_request = device
        self.device: torch.device | None = None
        if profile is not None:
            self.init(ErasureCodeProfile.parse(profile))

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.device = devsel.resolve(
            profile.get("device", self._device_request))
        if "mapping" in profile:
            mapping = profile["mapping"]
            layers_spec = profile.get("layers", "[]")
            if isinstance(layers_spec, str):
                layers_spec = json.loads(layers_spec)
        else:
            k = profile.get_int("k", 4)
            m = profile.get_int("m", 2)
            l = profile.get_int("l", 3)
            mapping, layers_spec = generate_kml(k, m, l)
        self.mapping = mapping
        self.layers = [_Layer(lm, cfg, self.device)
                       for lm, cfg in layers_spec]
        self.k = mapping.count("D")
        self.m = len(mapping) - self.k
        for layer in self.layers:
            if len(layer.mapping) != len(mapping):
                raise ValueError(
                    f"layer {layer.mapping!r} length != mapping "
                    f"{mapping!r}")
        log.dout(5, "lrc init", mapping=mapping,
                 layers=[la.mapping for la in self.layers])

    # -- geometry ---------------------------------------------------------
    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_chunk_mapping(self) -> list[int]:
        """chunk id -> mapping position: ids 0..k-1 are the D positions in
        order, ids k.. are the parity positions in order
        (ref: ErasureCodeInterface.h get_chunk_mapping)."""
        dpos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        ppos = [i for i, ch in enumerate(self.mapping) if ch != "D"]
        return dpos + ppos

    def _pos_of(self) -> list[int]:
        return self.get_chunk_mapping()

    def _id_of(self) -> dict[int, int]:
        return {p: i for i, p in enumerate(self.get_chunk_mapping())}

    # -- encode -----------------------------------------------------------
    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        """(k, C) data -> (n-k, C) parity, in non-D position order.

        Single-stripe view of encode_batch (one algorithm, one code path).
        """
        return to_host(self.encode_batch(np.asarray(data)[None])[0])

    def _positions(self) -> tuple[list[int], list[int]]:
        dpos = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        ppos = [i for i, ch in enumerate(self.mapping) if ch != "D"]
        return dpos, ppos

    def encode_batch(self, data) -> torch.Tensor:
        """(B, k, C) -> (B, m, C) on the device: each layer is one batched
        kernel launch over the stripe batch (stays on the device between
        layers)."""
        if not isinstance(data, torch.Tensor):
            data = np.ascontiguousarray(data, dtype=np.uint8)
        data = torch.as_tensor(data, dtype=torch.uint8, device=self.device)
        B, _, C = data.shape
        dpos, ppos = self._positions()
        chunks = torch.zeros((B, len(self.mapping), C), dtype=torch.uint8,
                             device=self.device)
        chunks[:, dpos] = data
        for layer in self.layers:
            chunks[:, layer.coding_pos] = layer.code.encode_batch(
                chunks[:, layer.data_pos])
        return chunks[:, ppos]

    def encode_batch_reference(self, data) -> np.ndarray:
        """Host-only mirror of ``encode_batch`` (each layer's
        ``encode_batch_reference``, numpy): the last rung of the OSD
        aggregator's degrade ladder for a plugin on the CPU.
        (B, k, C) uint8 -> (B, m, C)."""
        data = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
        B, _, C = data.shape
        dpos, ppos = self._positions()
        chunks = np.zeros((B, len(self.mapping), C), dtype=np.uint8)
        chunks[:, dpos] = data
        for layer in self.layers:
            chunks[:, layer.coding_pos] = layer.code.encode_batch_reference(
                chunks[:, layer.data_pos])
        return chunks[:, ppos]

    def _position_chunks(self, chunks: Mapping[int, np.ndarray],
                         C: int) -> tuple[np.ndarray, set[int]]:
        n = len(self.mapping)
        arr = np.zeros((n, C), dtype=np.uint8)
        have = set()
        for i, c in chunks.items():
            arr[i] = c
            have.add(i)
        return arr, have

    def decode_chunks(self, want: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Iterative layer repair (ref: ErasureCodeLrc::decode): sweep
        layers, decoding any layer whose erasures are recoverable, until
        the wanted chunks exist or no layer makes progress.

        `want`/`chunks` use chunk ids (data-first); internally everything
        is positional via get_chunk_mapping."""
        pos_of = self._pos_of()
        id_of = self._id_of()
        pchunks = {pos_of[i]: c for i, c in chunks.items()}
        out = self._decode_positions([pos_of[i] for i in want], pchunks)
        return {id_of[p]: v for p, v in out.items()}

    def _decode_positions(self, want: Sequence[int],
                          chunks: Mapping[int, np.ndarray]
                          ) -> dict[int, np.ndarray]:
        C = next(iter(chunks.values())).shape[0]
        arr, have = self._position_chunks(chunks, C)
        want_set = set(want)
        for _ in range(len(self.layers) + 1):
            if want_set <= have:
                break
            progress = False
            for layer in self.layers:
                missing = [p for p in layer.positions if p not in have]
                if not missing:
                    continue
                avail = [p for p in layer.positions if p in have]
                if len(avail) < layer.k:
                    continue
                # layer-local ids
                local_id = {p: j for j, p in enumerate(
                    layer.data_pos + layer.coding_pos)}
                sub = {local_id[p]: arr[p] for p in avail}
                out = layer.code.decode_chunks(
                    [local_id[p] for p in missing], sub)
                for p in missing:
                    arr[p] = out[local_id[p]]
                    have.add(p)
                progress = True
            if not progress:
                break
        if not want_set <= have:
            raise ValueError(
                f"cannot decode {sorted(want_set - have)} from "
                f"{sorted(chunks)}")
        return {p: arr[p] for p in want}

    # -- repair planning --------------------------------------------------
    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> set[int]:
        """Cheapest chunk set: prefer a single layer that covers the
        erasures (local repair), else simulate the iterative decode
        (ref: ErasureCodeLrc::_minimum_to_decode layer walk).

        Speaks chunk ids; positional internally."""
        pos_of = self._pos_of()
        id_of = self._id_of()
        out = self._minimum_positions(
            {pos_of[i] for i in want_to_read},
            {pos_of[i] for i in available})
        return {id_of[p] for p in out}

    def _minimum_positions(self, want_to_read: Iterable[int],
                           available: Iterable[int]) -> set[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        missing = want - avail
        best: set[int] | None = None
        for layer in self.layers:
            pos = set(layer.positions)
            if not missing <= pos:
                continue
            layer_avail = sorted(pos & avail)
            if len(layer_avail) < layer.k:
                continue
            cand = set(layer_avail[:layer.k]) | (want & avail)
            if best is None or len(cand) < len(best):
                best = cand
        if best is not None:
            return best
        # multi-layer repair: simulate, tracking consumed reads
        have = set(avail)
        used: set[int] = set(want & avail)
        for _ in range(len(self.layers) + 1):
            if want <= have:
                break
            progress = False
            for layer in self.layers:
                pos = layer.positions
                miss = [p for p in pos if p not in have]
                la = [p for p in pos if p in have]
                if not miss or len(la) < layer.k:
                    continue
                used |= set(la[:layer.k]) & avail
                have |= set(miss)
                progress = True
            if not progress:
                break
        if not want <= have:
            raise ValueError(f"cannot decode {sorted(want - have)}")
        return used
