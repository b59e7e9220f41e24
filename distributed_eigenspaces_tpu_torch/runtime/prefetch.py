"""Host-to-device prefetch for block and window streams.

Counterpart of ``distributed_eigenspaces_tpu/runtime/prefetch.py``: a
producer thread runs the stream (disk read, host conversion) and places
each item on the device, keeping ``depth`` items in flight ahead of the
consumer, so reading and copying window t + 1 overlap the device work on
window t.

On a CUDA device the default placement copies a host tensor from pinned
memory on a side stream and waits for that copy in the producer thread
before handing the tensor over, so the consumer never reads a tensor whose
copy is still in flight; the tensor is recorded on the consumer's stream,
so its memory is not reused while the consumer's kernels may still read
it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PrefetchStats:
    """Ingest-pipeline counters for one prefetched stream. A consumer pull
    that found the queue empty is a ``stall`` (the device waited on the
    host: ingest-bound); a producer push that found the queue full is a
    ``producer_wait`` (the host ran ahead: compute-bound).
    ``occupancy_sum / yields`` is the mean queue depth the consumer saw.
    ``wait_s`` is the consumer's time blocked on the queue, in host
    seconds."""

    depth: int = 0
    yields: int = 0  # items delivered to the consumer
    stalls: int = 0  # consumer pulls that found the queue empty
    occupancy_sum: int = 0  # queue depth summed at each consumer pull
    producer_waits: int = 0  # producer pushes that found the queue full
    wait_s: float = 0.0  # consumer seconds blocked on the queue

    def as_dict(self) -> dict:
        out = {
            "depth": self.depth,
            "yields": self.yields,
            "stalls": self.stalls,
            "producer_waits": self.producer_waits,
            "wait_s": self.wait_s,
        }
        if self.yields:
            out["stall_fraction"] = round(self.stalls / self.yields, 4)
            out["mean_occupancy"] = round(self.occupancy_sum / self.yields, 3)
            out["verdict"] = (
                "ingest_bound" if self.stalls > self.yields // 2
                else "compute_bound"
            )
        return out


def device_placer(device="cuda") -> Callable:
    """``place(x) -> tensor on device``, the default placement of
    :func:`prefetch_stream`. On a CUDA device a host tensor is pinned and
    copied on a side stream, the copy waited for in the calling (producer)
    thread, and the result recorded on the consumer's current stream; a
    tensor already on the device passes through."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda x: torch.as_tensor(x).to(dev)
    consumer = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)

    def place(x):
        x = torch.as_tensor(x)
        if x.device.type == "cuda":
            return x
        with torch.cuda.stream(side):
            out = x.pin_memory().to(dev, non_blocking=True)
        side.synchronize()
        out.record_stream(consumer)
        return out

    return place


def prefetch_stream(
    stream: Iterable,
    *,
    depth: int = 2,
    place: Callable | None = None,
    stats: PrefetchStats | None = None,
    device="cuda",
) -> Iterator:
    """Wrap a stream with background production and device placement.

    ``place`` maps an item to its device-resident form (default:
    :func:`device_placer` for ``device``); ``depth`` items are kept ahead
    of the consumer. An exception in the producer is raised in the
    consumer at the item where it happened.

    The returned generator owns a producer thread. Abandoning it
    (``break``, or ``.close()``) stops the producer: it exits instead of
    blocking on the bounded queue, and ``close()`` waits up to a second for
    it. The producer reads ahead: up to ``depth + 1`` items may already be
    taken from the underlying iterable when the consumer stops.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    put = place if place is not None else device_placer(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()
    if stats is not None:
        stats.depth = depth

    def q_put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        if stats is not None and q.full():
            stats.producer_waits += 1
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(stream)
            # stop is checked before each pull: a closed stream takes no
            # further item from its source
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    q_put(_END)
                    return
                if not q_put(put(item)):
                    return
        except BaseException as e:  # raised again in the consumer
            q_put(e)

    t = threading.Thread(target=producer, name="det-prefetch", daemon=True)
    t.start()

    def gen():
        try:
            while True:
                occ = q.qsize() if stats is not None else 0
                t0 = time.perf_counter()
                item = q.get()
                if stats is not None:
                    stats.wait_s += time.perf_counter() - t0
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                if stats is not None:
                    # counted for real items only: the end-of-stream pull is
                    # no stall anyone can fix
                    stats.yields += 1
                    stats.occupancy_sum += occ
                    if occ == 0:
                        stats.stalls += 1
                yield item
        finally:
            # the consumer finished or left: release the producer
            stop.set()
            while True:  # drain so a blocked q_put wakes at once
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=1.0)

    return gen()
