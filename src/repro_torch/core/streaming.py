"""Host→device streaming for host residency: byte payloads and a two-slot copy ring.

Under ``residency="host"`` the edge topology the memory budget does not pin
stays in host memory and goes up to the card once a sweep
(:mod:`repro_torch.core.session`). What goes up is laid out here, once per
staged graph, as flat byte payloads: each unit (a padded sub-shard block,
or a chunk of tiles) is its arrays back to back in one uint8 buffer, so a
unit is one host→device copy. On a CUDA session the buffers are
page-locked, and :class:`CopyRing` copies each unit on a stream of its own
into one of two device slots allocated once, with events ordering the copy
against the kernels that read the slot. On the CPU the same calls copy
between CPU tensors, so a CPU run takes the same path and charges the same
bytes.

Under ``residency="disk"`` a unit is read from the ``.dsss`` file's mmap
views each sweep: it is laid into one of two page-locked host buffers
(:class:`HostSlots`) that are filled in turn, each reused only once the
copy out of it has finished.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["layout", "host_buffer", "fill", "typed_views", "upload", "HostSlots", "CopyRing"]


def layout(arrays: dict) -> tuple[dict, int]:
    """Byte layout of ``arrays`` laid back to back, in the dict's order.

    Returns ``{name: (byte offset, numpy dtype, shape)}`` and the total
    bytes; ``None`` entries are left out. The arrays here hold 4-byte
    elements, so each section starts 4-byte aligned.
    """
    out, offset = {}, 0
    for name, a in arrays.items():
        if a is None:
            continue
        out[name] = (offset, a.dtype, a.shape)
        offset += a.nbytes
    return out, offset


def host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    """A uint8 host buffer, page-locked when ``pin`` (copies from it can be async)."""
    return torch.empty(max(int(nbytes), 1), dtype=torch.uint8, pin_memory=pin)


def fill(buf: np.ndarray, sections: dict, arrays: dict) -> None:
    """Write ``arrays`` into the uint8 numpy view ``buf`` at their ``sections``."""
    for name, (offset, _, _) in sections.items():
        a = np.ascontiguousarray(arrays[name]).reshape(-1)
        buf[offset:offset + a.nbytes] = a.view(np.uint8)


def typed_views(buf: torch.Tensor, sections: dict) -> dict:
    """The sections of a uint8 tensor as typed views of their shapes."""
    out = {}
    for name, (offset, dtype, shape) in sections.items():
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        out[name] = buf[offset:offset + n].view(tdtype).view(shape)
    return out


def upload(src: torch.Tensor, device: torch.device, stream=None):
    """Copy a host payload to ``device``: ``(device buffer, copy-done event or None)``.

    The buffer is allocated on the current stream. On CUDA the copy runs on
    ``stream`` after everything the current stream has queued so far (the
    buffer's memory may have been in use there), and the returned event
    marks its end: wait on it before reading the buffer.
    """
    dst = torch.empty(src.numel(), dtype=torch.uint8, device=device)
    if device.type != "cuda":
        dst.copy_(src)
        return dst, None
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return dst, done


class HostSlots:
    """Two host buffers, page-locked when ``pin``, that payloads fill in turn.

    :meth:`take` hands out the next buffer, first waiting (on the host) for
    the copy last queued out of it, and grows it when a payload is larger;
    :meth:`copied` records the event that marks that copy's end. So a
    payload is never overwritten while its copy may still read it.
    """

    def __init__(self, pin: bool):
        self.pin = pin
        self.bufs: list = [None, None]
        self.done: list = [None, None]
        self.n = 0

    def take(self, nbytes: int) -> tuple[int, torch.Tensor]:
        """``(slot, uint8 buffer of nbytes)``: the next slot, free to fill."""
        k = self.n % 2
        self.n += 1
        if self.done[k] is not None:
            self.done[k].synchronize()
            self.done[k] = None
        buf = self.bufs[k]
        if buf is None or buf.numel() < nbytes:
            buf = self.bufs[k] = host_buffer(nbytes, self.pin)
        return k, buf[:nbytes]

    def copied(self, k: int, event) -> None:
        """The copy out of slot ``k`` ends at ``event`` (``None``: already done)."""
        self.done[k] = event

    @property
    def nbytes(self) -> int:
        return sum(b.numel() for b in self.bufs if b is not None)


class CopyRing:
    """Two device slots that the chunks of a stream take in turn.

    Chunk ``c`` goes to slot ``c % 2``. On CUDA its copy runs on the ring's
    own stream; :meth:`take` makes the current (compute) stream wait for
    that copy, and :meth:`release`, called once chunk ``c``'s kernels are
    queued, marks when the slot is free again: the copy of chunk ``c + 2``
    waits for it. So at most two chunks are in flight, and no slot is
    overwritten while a kernel may still read it. The slots are allocated
    once; nothing is allocated per chunk. On the CPU the copies are
    immediate and the events are not needed.
    """

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        self.nbytes = int(nbytes)
        self.slots = [torch.empty(max(self.nbytes, 1), dtype=torch.uint8, device=device) for _ in range(2)]
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]
            self.free = [torch.cuda.Event(), torch.cuda.Event()]

    def begin(self) -> None:
        """Start a sweep's stream on the current (compute) stream: copies wait
        for what it queued so far."""
        if self.cuda:
            self.compute = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(self.compute)

    def put(self, c: int, src: torch.Tensor):
        """Queue chunk ``c``'s copy from the host payload ``src`` into its slot.

        Returns the event that marks the copy's end (``None`` off CUDA); it
        is recorded again by chunk ``c + 2``'s copy, so wait on it before
        queueing that one."""
        slot = self.slots[c % 2]
        n = src.numel()
        if n > self.nbytes:
            raise ValueError(f"a chunk of {n} bytes does not fit the ring's {self.nbytes}-byte slots")
        if not self.cuda:
            slot[:n].copy_(src)
            return None
        if c >= 2:
            self.stream.wait_event(self.free[c % 2])
        torch.cuda.set_stream(self.stream)  # copy_ runs on the current stream
        try:
            slot[:n].copy_(src, non_blocking=True)
        finally:
            torch.cuda.set_stream(self.compute)
        self.ready[c % 2].record(self.stream)
        return self.ready[c % 2]

    def take(self, c: int) -> torch.Tensor:
        """Chunk ``c``'s slot, once its copy is done (in stream order)."""
        if self.cuda:
            self.compute.wait_event(self.ready[c % 2])
        return self.slots[c % 2]

    def release(self, c: int) -> None:
        """Chunk ``c``'s kernels are queued: its slot is free after them."""
        if self.cuda:
            self.free[c % 2].record(self.compute)
