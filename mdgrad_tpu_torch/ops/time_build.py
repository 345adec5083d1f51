"""Time the kernel library's build two ways on the same machine.

    python -m mdgrad_tpu_torch.ops.time_build [--rounds 2]

Builds every ``csrc/*.cu`` source from scratch by the port's route
(:func:`_build.build`: one nvcc process per source, started together,
then one link) and by a single nvcc call over all sources, in the order
single, parallel, parallel, single for each round, so that both see the
same machine.  Prints each build's wall time and, last, one JSON line
with the medians.  Needs nvcc; writes only under ``_build/``.
"""

import argparse
import json
import statistics
import subprocess
import time

from . import _build


def single_call(path):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(path),
           *map(str, _build._sources())]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel(path):
    _build.build(path)
    return _build.build_seconds


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "time_build.so"
    times = {"single": [], "parallel": []}
    for _ in range(args.rounds):
        for route in ("single", "parallel", "parallel", "single"):
            path.unlink(missing_ok=True)
            s = single_call(path) if route == "single" else parallel(path)
            times[route].append(s)
            print(f"build {route}: {s:.3f} s", flush=True)
    path.unlink(missing_ok=True)
    print(json.dumps({"sources": len(_build._sources()), **{
        f"{route}_median_s": statistics.median(t)
        for route, t in times.items()}, "seconds": times}))


if __name__ == "__main__":
    main()
