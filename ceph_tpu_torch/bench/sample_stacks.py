"""Where a script's main thread spends its time, by sampling.

    python -m ceph_tpu_torch.bench.sample_stacks [--every S] [--out FILE]
        SCRIPT [ARGS...]

Runs SCRIPT as ``__main__`` (its own directory first on ``sys.path``)
while a thread samples the main thread's stack every S seconds (0.05 by
default). At exit it writes three tables to FILE (default
``build/stack_samples.txt``), each in seconds (samples times S): the
innermost frame in SCRIPT (function and line), that frame with the leaf
frame under it, and every function on the stack, inclusive. A coroutine
shows only while it runs; an ``asyncio.run`` that waits on other
processes shows as its own line in SCRIPT. The cost is one walk of the
stack per sample.
"""

from __future__ import annotations

import atexit
import collections
import os
import runpy
import sys
import threading
import time


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    every, out = 0.05, os.path.join("build", "stack_samples.txt")
    while args and args[0] in ("--every", "--out"):
        if args[0] == "--every":
            every = float(args[1])
        else:
            out = args[1]
        args = args[2:]
    if not args:
        raise SystemExit(__doc__)
    script = os.path.abspath(args[0])
    main_id = threading.get_ident()
    by_line, by_pair, by_func = (collections.Counter() for _ in range(3))
    done = threading.Event()

    def sample() -> None:
        while not done.wait(every):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            code = frame.f_code
            leaf = f"{os.path.basename(code.co_filename)}:{code.co_name}"
            mine, seen = None, set()
            while frame is not None:
                code = frame.f_code
                if mine is None and code.co_filename == script:
                    mine = f"{code.co_name}:{frame.f_lineno}"
                seen.add(f"{os.path.basename(code.co_filename)}:"
                         f"{code.co_name}")
                frame = frame.f_back
            by_line[mine] += 1
            by_pair[(mine, leaf)] += 1
            by_func.update(seen)

    def write() -> None:
        done.set()
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(f"# {script}: samples of {every} s\n")
            for title, table, n in (
                    ("innermost frame in the script", by_line, 80),
                    ("(that frame, leaf frame)", by_pair, 80),
                    ("every function on the stack", by_func, 150)):
                f.write(f"## {title}\n")
                for key, count in table.most_common(n):
                    f.write(f"{count * every:9.2f} s  {key}\n")

    atexit.register(write)
    threading.Thread(target=sample, daemon=True).start()
    sys.path.insert(0, os.path.dirname(script))
    sys.argv = [script] + args[1:]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
