"""AdminSocket: the per-daemon out-of-band command endpoint.

ref: src/common/admin_socket.{h,cc} — each daemon listens on a unix
socket; ``ceph daemon <sock> <command>`` connects, sends the command,
reads one json reply. Commands register with a handler; every daemon
gets the stock set (perf dump, config show, dump_ops_in_flight,
dump_historic_ops, log dump, help).

Client side: ``daemon_command(path, cmd)`` — the `ceph daemon` verb.

The port's copy of ``ceph_tpu/utils/admin_socket.py``.
"""

from __future__ import annotations

import asyncio
import inspect
import json
from typing import Callable

from ceph_tpu_torch.utils.logging import dump_recent, get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

log = get_logger("asok")


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._commands: dict[str, tuple[Callable, str]] = {}
        self._server: asyncio.AbstractServer | None = None
        self.register("help", self._help, "list registered commands")
        self.register("perf dump",
                      lambda: PerfCountersCollection.instance().dump(),
                      "dump perf counters")
        self.register("perf histogram dump", _histogram_dump,
                      "TYPE_HISTOGRAM counters as cumulative "
                      "le-bucketed series (count/sum/buckets)")
        self.register("log dump", lambda: {"recent": dump_recent()},
                      "dump the in-memory log ring")

    def register(self, prefix: str, fn: Callable,
                 desc: str = "") -> None:
        """ref: AdminSocket::register_command. ``desc`` is REQUIRED:
        the dump surface is big enough to rot silently, and `help` is
        its only index — an undocumented verb fails registration (the
        test_meta guard enforces the same statically)."""
        if not desc:
            raise ValueError(
                f"admin socket command {prefix!r} registered without "
                f"a description (help would list it blank)")
        self._commands[prefix] = (fn, desc)

    def _help(self) -> dict:
        return {name: desc for name, (_, desc) in
                sorted(self._commands.items())}

    async def start(self) -> None:
        import os
        try:
            os.unlink(self.path)       # stale socket from a SIGKILL
        except OSError:
            pass
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        import os
        try:
            os.unlink(self.path)
        except OSError:
            pass

    async def _serve(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(),
                                          timeout=5.0)
            try:
                cmd = json.loads(line)
            except json.JSONDecodeError:
                cmd = {"prefix": line.decode(errors="replace").strip()}
            prefix = cmd.get("prefix", "")
            ent = self._commands.get(prefix)
            if ent is None:
                out = {"error": f"unknown command {prefix!r}",
                       "commands": sorted(self._commands)}
            else:
                fn, _ = ent
                result = fn(cmd) if _wants_arg(fn) else fn()
                if inspect.isawaitable(result):
                    result = await result
                out = result
            payload = json.dumps(out, default=str).encode()
            writer.write(len(payload).to_bytes(4, "little") + payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError) as e:
            log.dout(5, f"admin socket client error: {e}")
        finally:
            writer.close()


def _histogram_dump() -> dict:
    """Every TYPE_HISTOGRAM counter in the process collection as
    {logger: {counter: {count, sum, buckets: [[le, cumulative]...]}}}
    (ref: `ceph daemon ... perf histogram dump`)."""
    from ceph_tpu_torch.utils.perf_counters import hist_cumulative
    out: dict = {}
    for name, counters in PerfCountersCollection.instance() \
            .dump().items():
        for key, val in counters.items():
            if isinstance(val, dict) and "log2_buckets" in val:
                out.setdefault(name, {})[key] = {
                    "count": val["count"], "sum": val["sum"],
                    "buckets": hist_cumulative(val["log2_buckets"]),
                }
    return out


def _wants_arg(fn: Callable) -> bool:
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


async def daemon_command(path: str, cmd: dict | str) -> dict:
    """The `ceph daemon <sock> <cmd>` client verb."""
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        payload = json.dumps(cmd if isinstance(cmd, dict)
                             else {"prefix": cmd})
        writer.write(payload.encode() + b"\n")
        await writer.drain()
        ln = int.from_bytes(await reader.readexactly(4), "little")
        return json.loads(await reader.readexactly(ln))
    finally:
        writer.close()
