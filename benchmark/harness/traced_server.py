"""The server of a traced run: ``python -m authorino_tpu_torch`` as usual,
under ``torch.profiler`` with CUDA activities for its whole life.

    python benchmark/harness/traced_server.py server <the server's flags>

In the main thread, before the server starts and before any CUDA
context exists, the profiler starts (CUPTI then sees every kernel, copy
and set of every thread of the process).  Two tiny kernels follow on a
stream of their own; the second is the anchor: the host's monotonic time
around its launch and completion ties the trace's clock to the host's.
When the process exits, the trace is exported as Chrome-trace JSON to
``$BENCH_TRACE_OUT`` and the anchor written beside it as
``$BENCH_TRACE_OUT.anchor.json``.  Without a CUDA card no profiler runs
and only the anchor file is written, empty.  Untraced runs start the
server without any of this.
"""

from __future__ import annotations

import atexit
import json
import os
import runpy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def anchor(torch) -> dict:
    """Launch the anchor kernel; the host's monotonic clock before its
    launch and after its completion."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x = torch.empty(1, device="cuda")
        x.fill_(1.0)                    # loads the kernel: not the anchor
        stream.synchronize()
        t0 = time.monotonic()
        x.fill_(2.0)
        stream.synchronize()
        t1 = time.monotonic()
    return {"kernels_before": 1, "host_t0": t0, "host_t1": t1}


def main() -> None:
    # the checkout's root where ``-m`` would put the working directory,
    # and not this script's directory, whose module names are the
    # harness's
    sys.path[0] = str(ROOT)
    import torch

    out = os.environ["BENCH_TRACE_OUT"]
    meta = {"trace": None}
    if torch.cuda.is_available():
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        meta.update(anchor(torch), trace=out)

        def finish() -> None:
            prof.stop()
            prof.export_chrome_trace(out)
            Path(out + ".anchor.json").write_text(json.dumps(meta))

        atexit.register(finish)
    else:
        Path(out + ".anchor.json").write_text(json.dumps(meta))
    sys.argv[0] = "authorino_tpu_torch"
    runpy.run_module("authorino_tpu_torch", run_name="__main__",
                     alter_sys=True)


if __name__ == "__main__":
    main()
