"""Host input-pipeline throughput: PNG decode + resize, frames per second.

Counterpart of ``rtsds_tpu/bench/io_bench.py``.  The port decodes on the
host with PIL in a thread pool (``data/pipeline.py:decode_image``, PIL's
antialiased bilinear resize when the frame is not at the served size); the
JAX package's C++ host decoder (``native/``) is not ported, so
``native_available`` is always false.  The frames are structured (16x16
blocks of random colour, not white noise), written as PNGs to a temporary
directory, and decoded ``repeats`` times: one thread, and the pool of
``n_threads``; the best of each is reported.  It runs on the CPU alone.

Run: ``python -m rtsds_tpu_torch.bench.io_bench`` (env: IO_N, IO_THREADS,
IO_HW, IO_OUT_HW); prints one JSON line.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rtsds_tpu_torch.data.pipeline import decode_image


def io_benchmark(n_images: int = 24, hw=(1024, 2048), out_hw=None,
                 n_threads: int = 8, repeats: int = 3) -> dict:
    """Decode (and resize to ``out_hw``) ``n_images`` PNGs of ``hw``:
    ``pil_fps`` on one thread, ``threaded_fps`` on ``n_threads``."""
    from PIL import Image

    out_hw = tuple(out_hw or hw)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(n_images):
            base = rng.integers(0, 256, size=(hw[0] // 16, hw[1] // 16, 3),
                                dtype=np.uint8)
            img = np.kron(base, np.ones((16, 16, 1), dtype=np.uint8))
            paths.append(os.path.join(d, f"{i}.png"))
            Image.fromarray(img).save(paths[-1])

        def best_seconds(decode_all) -> float:
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                frames = decode_all()
                times.append(time.perf_counter() - t0)
                if len(frames) != n_images or frames[0].shape != (
                        *out_hw, 3):
                    raise AssertionError(f"decoded {len(frames)} frames of "
                                         f"{frames[0].shape}")
            return min(times)

        single = best_seconds(
            lambda: [decode_image(p, out_hw) for p in paths])
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            threaded = best_seconds(
                lambda: list(pool.map(lambda p: decode_image(p, out_hw),
                                      paths)))
    return {"n_images": n_images, "hw": list(hw), "out_hw": list(out_hw),
            "threads": n_threads, "repeats": repeats,
            # decode scales with the host's cores: the count says what
            # machine a figure came from
            "host_cores": os.cpu_count(), "native_available": False,
            "pil_fps": n_images / single,
            "pil_ms_per_image": single / n_images * 1e3,
            "threaded_fps": n_images / threaded,
            "threaded_ms_per_image": threaded / n_images * 1e3,
            "speedup_vs_pil": single / threaded}


def main():
    hw = tuple(int(v) for v in os.environ.get("IO_HW", "1024,2048").split(","))
    out_hw = os.environ.get("IO_OUT_HW")
    stats = io_benchmark(
        n_images=int(os.environ.get("IO_N", "24")), hw=hw,
        out_hw=tuple(int(v) for v in out_hw.split(",")) if out_hw else None,
        n_threads=int(os.environ.get("IO_THREADS", "8")))
    print(json.dumps({
        "metric": f"host_png_decode_fps_{hw[0]}x{hw[1]}",
        "value": stats["threaded_fps"], "unit": "images/sec", **stats}))


if __name__ == "__main__":
    main()
