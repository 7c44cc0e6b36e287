"""Host-side data loading: samplers, collation, a threaded loader and the
copy of its batches to the device.

Counterpart of ``lednet_tpu/datasets/loader.py`` (``InfiniteSampler`` :22,
``DefaultSampler`` :40, ``_pad_stack``/``collate`` :60-99, ``DataLoader``
:101, ``build_dataloader`` :169, ``prefetch_to_device`` :194).  Rank r of
world W takes indices r, r+W, r+2W, ... of the shuffled order.  Samples are
prepared in a thread pool (the PNG decode, resizes and color conversions
run in native code without the interpreter lock).

Each sample draws from its own ``np.random.RandomState`` seeded from (the
loader's seed, its position in the sample stream), so a batch does not
depend on ``num_workers`` or on thread timing; the JAX loader's transforms
draw from the global ``np.random`` across its threads.

:class:`DevicePrefetcher` replaces ``prefetch_to_device``: collation writes
straight into pinned host buffers, each batch is copied to the card on a
side stream ``depth`` batches ahead, the consumer's stream waits on the
copy's event, and a buffer is reused only after its copy has completed.
"""
from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from lednet_tpu_torch.registry import DATASETS

# (key, shape, dtype) -> the array that collation fills for that key
Allocator = Callable[[str, tuple, np.dtype], np.ndarray]


class InfiniteSampler:
    """Shuffled infinite index stream (mmengine InfiniteSampler semantics)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.seed)
        while True:
            order = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.rank::self.world_size].tolist()


class DefaultSampler:
    """One epoch, optionally shuffled, rank-strided."""

    def __init__(self, size: int, shuffle: bool = False, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        order = (np.random.default_rng(self.seed).permutation(self.size)
                 if self.shuffle else np.arange(self.size))
        yield from order[self.rank::self.world_size].tolist()

    def __len__(self) -> int:
        return (self.size - self.rank + self.world_size - 1) // self.world_size


def _pad_stack(arrs: List[np.ndarray], pad_val: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stack, bottom/right-padding smaller samples to the batch max with
    ``pad_val`` (a sample below the crop size after a down-scale), into
    ``out`` when given."""
    max_h = max(a.shape[0] for a in arrs)
    max_w = max(a.shape[1] for a in arrs)
    shape = (len(arrs), max_h, max_w) + arrs[0].shape[2:]
    if out is None:
        out = np.empty(shape, arrs[0].dtype)
    for i, a in enumerate(arrs):
        h, w = a.shape[:2]
        out[i, :h, :w] = a
        if h < max_h or w < max_w:
            out[i, h:] = pad_val
            out[i, :h, w:] = pad_val
    return out


def collate(items: List[Dict], alloc: Optional[Allocator] = None) -> Dict[str, Any]:
    """Stack samples (images padded with 0, label maps with 255) and keep
    their metas as a list.  ``alloc`` supplies the arrays to stack into.

    A test-time-augmented sample (``tta_views``) makes a batch of its own
    (batch size 1): its views with their own inputs and metas, the first
    view's meta and its (1, H, W) labels at the original size."""
    if 'tta_views' in items[0]:
        if len(items) != 1:
            raise ValueError(f'test-time augmentation takes batch size 1, '
                             f'got {len(items)}')
        views = items[0]['tta_views']
        return dict(tta_views=views,
                    metainfo=[views[0]['metainfo']] if views else [{}],
                    gt_seg_map=(np.stack([views[0]['gt_seg_map']])
                                if views and 'gt_seg_map' in views[0] else None))
    batch: Dict[str, Any] = {}
    for key, pad_val in (('inputs', 0), ('gt_seg_map', 255), ('gt_edge_map', 255)):
        if key not in items[0]:
            continue
        arrs = [it[key] for it in items]
        out = None
        if alloc is not None:
            shape = (len(arrs), max(a.shape[0] for a in arrs),
                     max(a.shape[1] for a in arrs)) + arrs[0].shape[2:]
            out = alloc(key, shape, arrs[0].dtype)
        batch[key] = _pad_stack(arrs, pad_val, out)
    batch['metainfo'] = [it['metainfo'] for it in items]
    return batch


def sample_rng(seed: int, position: int) -> np.random.RandomState:
    """The generator of the sample at ``position`` in a loader's stream."""
    return np.random.RandomState([seed & 0xFFFFFFFF, position])


class DataLoader:
    """Batches of ``dataset`` in the sampler's order, prepared by
    ``num_workers`` threads up to ``prefetch`` batches ahead."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 2,
                 sampler: Optional[Any] = None, drop_last: bool = False,
                 prefetch: int = 4, infinite: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.sampler = sampler
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.infinite = infinite
        self.seed = seed

    def __len__(self) -> int:
        n = len(self.sampler) if hasattr(self.sampler, '__len__') else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[List[int]]:
        it = iter(self.sampler) if self.sampler is not None \
            else iter(range(len(self.dataset)))
        while True:
            idx = list(itertools.islice(it, self.batch_size))
            if not idx or len(idx) < self.batch_size and self.drop_last:
                return
            yield idx

    def __iter__(self) -> Iterator[Dict]:
        return self.batches()

    def batches(self, slots: Optional['PinnedSlots'] = None) -> Iterator[Dict]:
        """The batches; with ``slots`` each is collated into the next free
        pinned slot, which the batch names under ``'_slot'``."""
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    pass
            return False

        def assemble(futures) -> Dict:
            items = [f.result() for f in futures]
            if slots is None:
                return collate(items)
            slot = slots.acquire(stop)
            batch = collate(items, slot.array)
            batch['_slot'] = slot
            return batch

        def produce():
            try:
                pending: collections.deque = collections.deque()
                position = 0
                for idx in self._index_batches():
                    pending.append([pool.submit(self.dataset.prepare, i,
                                                sample_rng(self.seed, position + j))
                                    for j, i in enumerate(idx)])
                    position += len(idx)
                    if len(pending) >= self.prefetch and not put(assemble(pending.popleft())):
                        return
                while pending:
                    if not put(assemble(pending.popleft())):
                        return
            except BaseException as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            if slots is not None:
                slots.close()
            thread.join(timeout=10)
            pool.shutdown(wait=False, cancel_futures=True)


def build_dataloader(cfg: Dict, rank: int = 0, world_size: int = 1,
                     seed: int = 0, default_batch_size: Optional[int] = None
                     ) -> DataLoader:
    """A DataLoader from an mmseg dataloader config (``batch_size``,
    ``num_workers``, ``sampler``, ``dataset``)."""
    cfg = dict(cfg)
    dataset = DATASETS.build(dict(cfg['dataset']))
    sampler_cfg = dict(cfg.get('sampler', dict(type='DefaultSampler')))
    stype = sampler_cfg.pop('type', 'DefaultSampler')
    shuffle = sampler_cfg.pop('shuffle', False)
    infinite = stype == 'InfiniteSampler'
    sampler = (InfiniteSampler if infinite else DefaultSampler)(
        len(dataset), shuffle=shuffle, seed=seed, rank=rank,
        world_size=world_size)
    return DataLoader(dataset, batch_size=cfg.get('batch_size', default_batch_size or 1),
                      num_workers=cfg.get('num_workers', 2), sampler=sampler,
                      infinite=infinite, drop_last=cfg.get('drop_last', False),
                      seed=seed)


# ------------------------------------------------------------- to the device
class _Slot:
    """Pinned host buffers for one batch, one per key, grown as needed;
    free again once the copy to the device that read them has completed."""

    def __init__(self):
        self.buffers: Dict[str, Any] = {}
        self.views: Dict[str, Any] = {}
        self.free = threading.Event()
        self.free.set()
        self.copied = None            # the CUDA event of the last copy

    def array(self, key: str, shape: tuple, dtype) -> np.ndarray:
        import torch
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = self.buffers[key] = torch.empty(nbytes, dtype=torch.uint8,
                                                  pin_memory=True)
        view = buf[:nbytes].view(tdtype).view(shape)
        self.views[key] = view
        return view.numpy()


class PinnedSlots:
    """A ring of pinned batch buffers shared by a loader's producer thread
    (:meth:`acquire`) and :class:`DevicePrefetcher` (:meth:`release`)."""

    def __init__(self, n: int):
        self._slots = [_Slot() for _ in range(max(1, n))]
        self._next = 0

    def acquire(self, stop: threading.Event) -> _Slot:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        while not slot.free.wait(timeout=0.1):
            if stop.is_set():
                raise RuntimeError('the loader was closed')
        slot.free.clear()
        if slot.copied is not None:
            slot.copied.synchronize()    # its last batch is on the card
        slot.views = {}
        return slot

    @staticmethod
    def release(slot: _Slot, copied) -> None:
        slot.copied = copied
        slot.free.set()

    def close(self) -> None:
        for slot in self._slots:
            slot.free.set()


class DevicePrefetcher:
    """Iterate a :class:`DataLoader`'s batches as tensors on ``device``,
    each copied from pinned memory on a side stream ``depth`` batches ahead
    of its use.  Arrays become tensors; other keys pass through.
    ``wait_s`` sums the host seconds spent waiting on the loader."""

    def __init__(self, loader: DataLoader, device, depth: int = 2):
        import torch
        self.loader = loader
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError('DevicePrefetcher copies to a CUDA device; on '
                             'the CPU iterate the loader itself')
        self.depth = max(1, depth)
        self.wait_s = 0.0

    def __iter__(self) -> Iterator[Dict]:
        import time

        import torch
        slots = PinnedSlots(self.loader.prefetch + self.depth + 1)
        host = self.loader.batches(slots)
        stream = torch.cuda.Stream(self.device)
        ahead: collections.deque = collections.deque()

        def issue() -> bool:
            t0 = time.perf_counter()
            batch = next(host, None)
            self.wait_s += time.perf_counter() - t0
            if batch is None:
                return False
            slot = batch.pop('_slot')
            with torch.cuda.stream(stream):
                for key, view in slot.views.items():
                    batch[key] = view.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            slots.release(slot, done)
            ahead.append((batch, done))
            return True

        try:
            while len(ahead) < self.depth and issue():
                pass
            while ahead:
                batch, done = ahead.popleft()
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for value in batch.values():
                    if isinstance(value, torch.Tensor):
                        value.record_stream(current)
                issue()
                yield batch
        finally:
            host.close()
