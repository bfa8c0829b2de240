"""Multiprocess window-scoped video decoder pool.

The reference decodes inline in its tracking loop, single-stream
(ref: core_testcode.cpp:99-122). Here host decode is the dominant
real-video cost (device tracking is a small fraction of it), so the
window-scoped pair ranges shard across N decoder PROCESSES — each owns
its own cv2.VideoCapture, seeks its own chunk starts, decodes raw-luma
Y planes straight into a shared-memory ring, and the consumer emits
frames in global order. Python threads cannot parallelize cv2 decode
reliably (the decoder serializes per stream and the numpy conversion
holds the GIL); processes can.

On a single-core host the pool degrades to the classic decode-ahead THREAD (zero spawn cost, no
redundant seeks, still overlaps device tracking) — worker processes
only help when there are cores for them, so `n_workers` defaults to
the CPU affinity count capped at 4.

Worker processes import only cv2/numpy (see _decode_worker_main):
spawn-context startup stays ~1 s and never initializes jax or opens
the accelerator.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

#: frames per seek+decode chunk in process mode. Seeking costs a
#: keyframe-to-position decode of up to one GOP (cv2's mp4 writers
#: default to small GOPs, real GoPro H.264 to ~30 frames), so chunks
#: amortize it to a few percent.
PROC_CHUNK = 128

#: shared-memory ring slots per worker (bounds decode-ahead memory to
#: slots * H * W bytes per worker; 32 slots at 2.7k = ~175 MB).
RING_SLOTS = 32


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def available_workers(n_workers: int | None = None) -> int:
    """Heuristic decoder parallelism: CPU affinity count capped at 4.
    Used as the cheap default; `probe_workers` replaces it with a
    measured choice when enough frames are at stake to amortize the
    probe (the cap-at-4 guess is a heuristic, not a measurement)."""
    if n_workers is not None:
        return max(1, int(n_workers))
    return max(1, min(4, _cores()))


#: measured best worker count per (path, affinity), process lifetime
_PROBE_CACHE: dict[tuple, int] = {}

#: minimum frames in a run before the measured probe pays for itself
#: (the probe re-decodes a ~48-frame burst per candidate, ~1-2 s each
#: including process spawn)
PROBE_MIN_FRAMES = 400


def probe_workers(
    path: str,
    height: int,
    width: int,
    raw: bool,
    max_frames: int,
    burst: int = 48,
    candidates: Sequence[int] | None = None,
) -> int:
    """Pick the worker count by MEASURED decode throughput: time a
    short DecodePool burst per candidate and keep the fastest. Spawn
    cost is included in each burst, which biases toward fewer workers
    — conservative, since real runs amortize spawn over far more
    frames. Cached per (path, affinity) for the process lifetime."""
    import time

    cores = _cores()
    if candidates is None:
        if cores <= 1:
            return 1  # processes cannot help without cores to run on
        candidates = sorted({1, 2, min(4, cores)} | (
            {min(6, cores)} if cores > 4 else set()
        ))
    burst = min(burst, max_frames)
    if burst < 8:
        return available_workers(None)
    key = (os.path.abspath(path), cores, tuple(candidates))
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    best_k, best_dt = 1, float("inf")
    for k in candidates:
        t0 = time.perf_counter()
        with DecodePool(
            path, [(0, burst)], height, width, raw, k,
            chunk=max(8, -(-burst // max(k, 1))),
        ) as pool:
            for _ in pool.span_frames(0):
                pass
        dt = time.perf_counter() - t0
        if dt < best_dt:
            best_k, best_dt = k, dt
    _PROBE_CACHE[key] = best_k
    return best_k


def _decode_worker_main(
    path: str,
    raw: bool,
    height: int,
    width: int,
    chunks: Sequence[tuple[int, int]],
    shm_name: str,
    n_slots: int,
    out_q,
    free_sem,
    delay_s: float = 0.0,
) -> None:
    """Decoder process entry: decode `chunks` (frame ranges) in order,
    writing Y planes into the shared ring and (frame_idx, slot, ts)
    records into out_q. Imports only cv2/numpy — safe under spawn.

    delay_s: per-frame sleep after each decode — fault injection for
    the concurrency stress tests (simulates a slow codec so ring
    exhaustion / out-of-order worker completion are exercised even on
    fast tiny fixtures)."""
    import time

    import cv2
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        buf = np.ndarray((n_slots, height, width), np.uint8, buffer=shm.buf)
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            out_q.put(("error", "video open failed"))
            return
        if raw:
            cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        slot = 0
        try:
            for c0, c1 in chunks:
                cap.set(cv2.CAP_PROP_POS_FRAMES, c0)
                if cap.get(cv2.CAP_PROP_POS_FRAMES) != c0:
                    raise RuntimeError(f"seek to frame {c0} failed")
                for idx in range(c0, c1):
                    ok, img = cap.read()
                    if not ok:
                        raise RuntimeError(f"frame read failed at {idx}")
                    if delay_s > 0.0:
                        time.sleep(delay_s)
                    ts = cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0
                    free_sem.acquire()
                    if raw:
                        # bare Y plane (H, W) or full I420 (H*3/2, W)
                        buf[slot] = img[:height]
                    else:
                        buf[slot] = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                    out_q.put((idx, slot, ts))
                    slot = (slot + 1) % n_slots
            out_q.put(None)
        except Exception as e:  # surfaced by the consumer
            out_q.put(("error", repr(e)))
        finally:
            cap.release()
    finally:
        shm.close()


class DecodePool:
    """Decode the frame spans in `spans` (each [start, stop)) with
    `n_workers` processes, yielding per-span iterators of
    (index, timestamp, gray) in frame order.

    Frames are bit-identical to a serial cv2 decode: every worker runs
    the same decoder over the same chunk boundaries a serial reader
    would cross, and cv2 frame seeks are exact (verified per seek)."""

    def __init__(
        self,
        path: str,
        spans: Sequence[tuple[int, int]],
        height: int,
        width: int,
        raw: bool,
        n_workers: int,
        chunk: int = PROC_CHUNK,
        slots: int = RING_SLOTS,
        worker_delay_s: float = 0.0,
    ):
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context("spawn")
        chunks: list[tuple[int, int]] = []
        self._span_chunk0: list[int] = []
        for b, e in spans:
            self._span_chunk0.append(len(chunks))
            chunks.extend(
                (c, min(c + chunk, e)) for c in range(b, e, chunk)
            )
        self._span_chunk0.append(len(chunks))
        n_workers = max(1, min(n_workers, len(chunks)))
        self._n = n_workers
        self._chunks = chunks
        self._slots = slots
        self._shms = []
        self._bufs = []
        self._qs = []
        self._sems = []
        self._procs = []
        self._done = [False] * n_workers
        self._next_slot = [0] * n_workers
        frame_bytes = height * width
        for w in range(n_workers):
            shm = shared_memory.SharedMemory(
                create=True, size=slots * frame_bytes
            )
            self._shms.append(shm)
            self._bufs.append(
                np.ndarray((slots, height, width), np.uint8, buffer=shm.buf)
            )
            q = ctx.Queue()
            sem = ctx.Semaphore(slots)
            self._qs.append(q)
            self._sems.append(sem)
            p = ctx.Process(
                target=_decode_worker_main,
                args=(path, raw, height, width, chunks[w::n_workers],
                      shm.name, slots, q, sem, worker_delay_s),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def _next_frame(self, w: int) -> tuple[int, int, float]:
        from queue import Empty

        while True:
            try:
                item = self._qs[w].get(timeout=1.0)
                break
            except Empty:
                # a killed/crashed worker leaves the queue silent
                # forever — a plain get() would hang the consumer.
                # Items already queued before death still drain first.
                if not self._procs[w].is_alive():
                    raise RuntimeError(
                        f"decoder worker {w} died "
                        f"(exitcode {self._procs[w].exitcode})"
                    )
        if item is None:
            raise RuntimeError("decoder worker ended early")
        if isinstance(item, tuple) and item and item[0] == "error":
            raise RuntimeError(f"decoder worker failed: {item[1]}")
        return item

    def span_frames(
        self, span_idx: int
    ) -> Iterator[tuple[int, float, np.ndarray]]:
        """Frames of span `span_idx`, in order. Spans must be consumed
        in order (workers fill the global chunk sequence)."""
        c0, c1 = self._span_chunk0[span_idx], self._span_chunk0[span_idx + 1]
        for ci in range(c0, c1):
            w = ci % self._n
            for idx in range(*self._chunks[ci]):
                got_idx, slot, ts = self._next_frame(w)
                if got_idx != idx:
                    raise RuntimeError(
                        f"decoder out of order: got {got_idx}, want {idx}"
                    )
                gray = self._bufs[w][slot].copy()
                self._sems[w].release()
                yield idx, ts, gray

    def close(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        for q in self._qs:
            q.close()
        for shm in self._shms:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
