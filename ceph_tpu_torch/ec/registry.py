"""Erasure-code plugin registry.

Mirrors the reference's registry semantics
(ref: src/erasure-code/ErasureCodePlugin.cc ErasureCodePluginRegistry:
singleton, ``factory(plugin_name, profile) -> ErasureCodeInterfaceRef``)
with in-process registration instead of dlopen.

``jax``, ``jerasure`` and ``isa`` all resolve to ``ErasureCodeTorch``, so
profiles and benchmark invocations written for the reference
(``--plugin jax``, ``--plugin jerasure``) run unchanged. ``isa`` takes the
reference's fallback branch (no native C++ backend here) and marks the
instance ``independent=False``. ``lrc``, ``shec`` and ``clay`` are the
layered plugins; ``ref`` (the native C++ backend) is not registered, and
asking for it raises the usual "not found".
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Mapping

from ceph_tpu_torch.ec.interface import (ErasureCodeInterface,
                                         ErasureCodeProfile)
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch

log = logging.getLogger("ceph_tpu_torch.ec")


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
        self.add("isa", ErasureCodeTorch)
        self.add("lrc", ErasureCodeLrc)
        self.add("shec", ErasureCodeShec)
        self.add("clay", ErasureCodeClay)

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

    def factory(self, name: str,
                profile: Mapping[str, str] | str) -> ErasureCodeInterface:
        """ref: ErasureCodePluginRegistry::factory."""
        prof = ErasureCodeProfile.parse(profile)
        prof.setdefault("plugin", name)
        ec = self.load(name)()
        ec.init(prof)
        if name == "isa":
            ec.independent = False
        log.debug("factory plugin=%s profile=%s", name, prof)
        return ec


def factory(profile: Mapping[str, str] | str) -> ErasureCodeInterface:
    """Build an EC backend from a profile carrying ``plugin=...``."""
    prof = ErasureCodeProfile.parse(profile)
    name = prof.get("plugin", "jax")
    return ErasureCodePluginRegistry.instance().factory(name, prof)
