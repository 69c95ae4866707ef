"""Erasure-code plugin registry.

Mirrors the reference's registry semantics
(ref: src/erasure-code/ErasureCodePlugin.cc ErasureCodePluginRegistry:
singleton, ``factory(plugin_name, profile) -> ErasureCodeInterfaceRef``)
with in-process registration instead of dlopen.

``jax`` and ``jerasure`` resolve to ``ErasureCodeTorch``, so profiles and
benchmark invocations written for the reference (``--plugin jax``,
``--plugin jerasure``) run unchanged. ``ref`` is the native C++ backend
(``interop.native.ErasureCodeRef``, built from ``native/`` on first use).
``isa`` resolves per profile, as in the reference: an RS or Cauchy
technique (``cauchy`` meaning ``cauchy_good``) gets the native backend,
marked ``independent=True``, when the toolchain can build it; any other
technique, or no toolchain, gets ``ErasureCodeTorch`` (on the card unless
the profile says ``device=cpu``), marked ``independent=False``, so a
cross-check can tell two implementations from one. ``lrc``, ``shec`` and
``clay`` are the layered plugins.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Callable, Mapping

from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.interop.native import ErasureCodeRef, build_native

log = logging.getLogger("ceph_tpu_torch.ec")


@functools.lru_cache(maxsize=1)
def _native_available() -> bool:
    """One build probe per process: factory() runs per EC instance and
    must not fork `make` every time."""
    try:
        build_native()
        return True
    except RuntimeError:
        log.info("isa: native backend unavailable, falling back to the "
                 "torch plugin")
        return False


class ErasureCodePluginRegistry:
    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: dict[str, Callable[[], ErasureCodeInterface]] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
                cls._instance._register_builtins()
            return cls._instance

    def _register_builtins(self) -> None:
        from ceph_tpu_torch.ec.clay import ErasureCodeClay
        from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
        from ceph_tpu_torch.ec.shec import ErasureCodeShec

        self.add("jax", ErasureCodeTorch)
        # Compatibility aliases: same techniques, same parity bytes.
        self.add("jerasure", ErasureCodeTorch)
        # "isa" resolves per profile in factory(): see _isa_ctor
        self.add("isa", ErasureCodeTorch)
        self.add("lrc", ErasureCodeLrc)
        self.add("shec", ErasureCodeShec)
        self.add("clay", ErasureCodeClay)
        # the build itself is lazy (first init), so registering is free
        self.add("ref", ErasureCodeRef)

    def add(self, name: str,
            ctor: Callable[[], ErasureCodeInterface]) -> None:
        """ref: ErasureCodePluginRegistry::add."""
        with self._lock:
            self._plugins[name] = ctor

    def load(self, name: str) -> Callable[[], ErasureCodeInterface]:
        """ref: ErasureCodePluginRegistry::load (dlopen analog)."""
        with self._lock:
            if name not in self._plugins:
                raise KeyError(
                    f"erasure-code plugin {name!r} not found; "
                    f"registered: {sorted(self._plugins)}")
            return self._plugins[name]

    def _isa_ctor(self, prof) -> tuple[type, bool]:
        """plugin=isa -> the INDEPENDENT native C++ RS backend, the role
        ISA-L plays upstream (an optimized CPU path distinct from
        jerasure), so a jerasure<->isa parity cross-check compares two
        implementations, not one backend under two names. RS/Cauchy
        techniques only; anything else, or a missing toolchain, gets the
        torch plugin with ``independent=False``."""
        tech = prof.get("technique", "reed_sol_van")
        mapped = {"cauchy": "cauchy_good"}.get(tech, tech)
        if mapped in ("reed_sol_van", "cauchy_orig", "cauchy_good") \
                and _native_available():
            prof["technique"] = mapped
            return ErasureCodeRef, True
        return ErasureCodeTorch, False

    def factory(self, name: str,
                profile: Mapping[str, str] | str) -> ErasureCodeInterface:
        """ref: ErasureCodePluginRegistry::factory."""
        prof = ErasureCodeProfile.parse(profile)
        prof.setdefault("plugin", name)
        independent = None
        if name == "isa":
            self.load(name)              # keep not-found semantics
            ctor, independent = self._isa_ctor(prof)
        else:
            ctor = self.load(name)
        ec = ctor()
        ec.init(prof)
        if independent is not None:
            ec.independent = independent
        log.debug("factory plugin=%s profile=%s", name, prof)
        return ec


def factory(profile: Mapping[str, str] | str) -> ErasureCodeInterface:
    """Build an EC backend from a profile carrying ``plugin=...``."""
    prof = ErasureCodeProfile.parse(profile)
    name = prof.get("plugin", "jax")
    return ErasureCodePluginRegistry.instance().factory(name, prof)
