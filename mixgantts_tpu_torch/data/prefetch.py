"""Background-thread batch prefetching (`mixgantts_tpu/data/prefetch.py`).

The training loop's host work (loading the `.npy` artifacts, padding,
bucket lookup in `AcousticDataset.batches`) otherwise serializes with the
device's: the next batch is only built after the previous step is queued.
A small bounded queue filled by a daemon thread overlaps the two.  Epoch
markers (`None`) pass through in order.
"""

import queue
import threading

_END = object()


def prefetch(iterator, size=2):
    """Wrap `iterator` so items are produced ahead of time on a daemon
    thread; keeps order, re-raises the producer's exception, forwards
    None."""
    q = queue.Queue(maxsize=size)

    def fill():
        try:
            for item in iterator:
                q.put((None, item))
        except BaseException as e:  # re-raised on the consumer side
            q.put((e, None))
        q.put((None, _END))

    threading.Thread(target=fill, daemon=True).start()
    while True:
        err, item = q.get()
        if err is not None:
            raise err
        if item is _END:
            return
        yield item
