"""Legacy ``paddle.reader`` namespace: functional reader combinators (port
of ``paddle_tpu/reader.py``: shuffle, buffered, compose, chain,
map_readers, firstn, xmap_readers, cache).

Pure-Python generator plumbing — identical semantics, no framework types.
"""
import itertools
import random

__all__ = ['buffered', 'cache', 'chain', 'compose', 'firstn', 'map_readers',
           'shuffle', 'xmap_readers']


def map_readers(func, *readers):
    """Element-wise func over zipped readers."""

    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader_creator, buf_size):
    """Buffered shuffle (reference semantics: shuffle within buf_size)."""

    def reader():
        buf = []
        for e in reader_creator():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return reader


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples; check_alignment=True raises on
    length mismatch (reference ComposeNotAligned)."""
    check = kwargs.pop('check_alignment', True)

    class ComposeNotAligned(ValueError):
        pass

    def _flat(items):
        out = []
        for it in items:
            if isinstance(it, tuple):
                out.extend(it)
            else:
                out.append(it)
        return tuple(out)

    def reader():
        its = [r() for r in readers]
        if not check:
            for items in zip(*its):
                yield _flat(items)
            return
        sentinel = object()
        for items in itertools.zip_longest(*its, fillvalue=sentinel):
            if sentinel in items:
                raise ComposeNotAligned(
                    'readers have different lengths (check_alignment=True)')
            yield _flat(items)

    return reader


def buffered(reader_creator, size):
    """Read-ahead buffer via a worker thread (reference uses a thread too)."""
    import queue
    import threading

    def reader():
        q = queue.Queue(maxsize=size)
        END = object()

        def fill():
            try:
                for e in reader_creator():
                    q.put(e)
            finally:
                q.put(END)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is END:
                break
            yield e

    return reader


def firstn(reader_creator, n):
    def reader():
        return itertools.islice(reader_creator(), n)

    return reader


def cache(reader_creator):
    """Materialize once, replay from memory afterwards."""
    data = []
    filled = []

    def reader():
        if not filled:
            for e in reader_creator():
                data.append(e)
            filled.append(True)
        return iter(data)

    return reader


def xmap_readers(mapper, reader_creator, process_num, buffer_size,
                 order=False):
    """Parallel map over a reader via a thread pool (the reference's
    process/thread hybrid collapsed to threads — mappers are usually
    numpy-bound decode work that releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    def reader():
        with ThreadPoolExecutor(max_workers=process_num) as ex:
            it = reader_creator()
            if order:
                yield from ex.map(mapper, it)
            else:
                import concurrent.futures as cf
                pending = set()
                for e in it:
                    pending.add(ex.submit(mapper, e))
                    if len(pending) >= buffer_size:
                        done, pending = cf.wait(
                            pending, return_when=cf.FIRST_COMPLETED)
                        for f in done:
                            yield f.result()
                for f in cf.as_completed(pending):
                    yield f.result()

    return reader
