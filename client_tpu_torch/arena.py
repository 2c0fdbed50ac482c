"""Pooled shared-memory arena: the zero-copy data plane's allocator.

Before this module, every shm use-site created, registered and destroyed its
own region (mmap + registration RPC per use-site; five independent such
blocks in ``perf.py`` alone) — under sustained traffic that churn IS the
data-plane cost. The arena flips the steady-state cost model:

- **Size-class slabs carved from a few large regions.** A lease request is
  rounded up to a power-of-two class and served from a free slab; only a
  cold class mmaps a new region (carved into many slabs at once), so
  steady-state region create/destroy ops are zero.
- **Ref-counted leases.** :class:`ArenaLease` is the handle a slab is held
  by: ``retain()``/``release()`` are thread-safe AND asyncio-safe (one
  short-held lock, no blocking waits), a double release raises, and a
  zero-copy ``as_numpy`` view taken after the last release raises
  :class:`ArenaLeaseReleased` instead of silently aliasing reused bytes.
- **LRU trimming with high/low watermarks.** Free slabs are kept for reuse
  until free bytes exceed ``high_watermark_bytes``; then fully-free regions
  are destroyed in least-recently-used order until free bytes fall to
  ``low_watermark_bytes`` — footprint/lifetime management in the spirit of
  the DNN-serving memory managers (arXiv:2001.03288, arXiv:2308.15152).
- **Cached server registrations.** ``ensure_registered`` keys
  ``register_{system,cuda}_shared_memory`` by ``(endpoint url, region)``:
  an RPC is issued only on a region's FIRST use against that endpoint,
  then cached until invalidated (endpoint ejection/reconnect via
  :meth:`ShmArena.invalidate_endpoint` — the pool wires this to its
  ejection events — or a server-side unregister, which the frontends
  report via :func:`notify_unregister`). Registration RPCs per request
  amortize to ~0.

The transparent fast path is wired at the client layer
(``InferInput.set_data_from_numpy(..., arena=...)`` stages straight into a
slab; a client configured with ``shm_arena=`` promotes staged binary inputs
into leases at ``infer()`` time and ``InferResult.as_numpy`` returns a
zero-copy view over the slab).

The port of ``client_tpu.arena``: the device family is ``"cuda"`` (regions
of ``utils.cuda_shared_memory``, a host window plus a cache of live CUDA
tensors) where the JAX package has ``"tpu"``; ``ArenaLease.write_torch`` /
``as_torch`` take the place of ``write_jax`` / ``as_jax``. A colocated
region (the default) skips the host mirror, so a server in this process
receives the leased CUDA tensor itself; a server in another process reads
the host window (no CUDA IPC, as in the JAX package).
"""

from __future__ import annotations

import asyncio
import atexit
import hashlib
import threading
import uuid as _uuid
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import flight as _flight
from . import observe as _observe
from .utils import (
    serialize_bf16_tensor,
    serialize_byte_tensor,
    triton_to_np_dtype,
)
from .utils.shared_memory import SharedMemoryException

__all__ = [
    "ArenaError",
    "ArenaLeaseReleased",
    "ArenaLease",
    "LeaseDigest",
    "ShmArena",
    "default_arena",
    "arenas",
    "notify_unregister",
    "bind_request",
    "bind_request_async",
]

_PAGE = 4096


class ArenaError(SharedMemoryException):
    """Raised on arena lifecycle misuse (double release, closed arena, ...)."""


class ArenaLeaseReleased(ArenaError):
    """A zero-copy view/read was requested from a lease after its last
    ``release()`` — the slab may already back a different lease."""


def _round_class(nbytes: int, min_class: int, max_class: int) -> int:
    """The size class serving ``nbytes``: next power of two clamped to
    [min_class, max_class]; oversize requests get a page-rounded class of
    their own (reused only by same-class leases)."""
    if nbytes > max_class:
        return (nbytes + _PAGE - 1) // _PAGE * _PAGE
    c = min_class
    while c < nbytes:
        c <<= 1
    return c


class LeaseDigest:
    """A blake2b-128 seal over the first ``nbytes`` of a lease's slab.

    Sealed when a response lands (output leases under an integrity
    policy with ``digests=True``; ``disagg``'s KV handoff) and
    re-verified at ``as_numpy()`` map time — a server that scribbles
    over shared memory AFTER answering is caught before the first read.
    The digest rides the lease object itself: no extra RPCs, ever.
    """

    DIGEST_SIZE = 16  # blake2b-128, matching disagg's KV handoff seal

    __slots__ = ("nbytes", "hexdigest")

    def __init__(self, nbytes: int, hexdigest: str):
        self.nbytes = nbytes
        self.hexdigest = hexdigest

    @classmethod
    def seal(cls, lease: "ArenaLease",
             nbytes: Optional[int] = None) -> "LeaseDigest":
        n = nbytes if nbytes is not None else (lease.nbytes
                                               or lease.byte_size)
        view = lease.memoryview()[:n]
        return cls(n, hashlib.blake2b(
            view, digest_size=cls.DIGEST_SIZE).hexdigest())

    def compute(self, lease: "ArenaLease") -> str:
        """The current content digest over this seal's span."""
        view = lease.memoryview()[:self.nbytes]
        return hashlib.blake2b(
            view, digest_size=self.DIGEST_SIZE).hexdigest()

    def verify(self, lease: "ArenaLease", url: str = "") -> None:
        """Re-hash and compare; mismatch raises a typed ``digest``
        ``integrity.IntegrityError`` (and counts into the process
        integrity stats so doctor/perf surface it)."""
        actual = self.compute(lease)
        if actual != self.hexdigest:
            from . import integrity as _integrity

            _integrity.global_stats().record_violation("digest", url)
            _flight.note("integrity", "violation", kind="digest",
                         url=url, field=lease.region_name)
            raise _integrity.IntegrityError(
                "digest", url, lease.region_name, self.hexdigest, actual)


class _ArenaRegion:
    """One large mapped region carved into same-class slabs."""

    __slots__ = (
        "family", "name", "key", "class_bytes", "slab_count", "byte_size",
        "handle", "free_count", "leased", "last_used", "registered",
        "device_id",
    )

    def __init__(self, family: str, name: str, key: str, class_bytes: int,
                 slab_count: int, handle: Any, device_id: int):
        self.family = family
        self.name = name
        self.key = key
        self.class_bytes = class_bytes
        self.slab_count = slab_count
        self.byte_size = class_bytes * slab_count
        self.handle = handle
        # free-slab OFFSETS live only in the arena's per-class freelist;
        # the region keeps a count (inventory/trim need nothing more)
        self.free_count = 0
        self.leased = 0
        self.last_used = 0                 # arena sequence number (LRU order)
        # endpoint url -> weakref(client) for best-effort unregister at trim
        self.registered: Dict[str, Any] = {}
        self.device_id = device_id

    def _host_view(self) -> memoryview:
        if self.family == "system":
            return self.handle.buf()
        return self.handle.host_buffer()


class ArenaLease:
    """A ref-counted hold on one slab of an arena region.

    Created with one reference; ``retain()`` adds holders, ``release()``
    drops one — the slab returns to the arena's free list when the count
    reaches zero. All data accessors raise :class:`ArenaLeaseReleased`
    once fully released.
    """

    __slots__ = ("_arena", "_region", "_offset", "_nbytes", "_refs",
                 "_digest")

    def __init__(self, arena: "ShmArena", region: _ArenaRegion, offset: int,
                 nbytes: int):
        self._arena = arena
        self._region = region
        self._offset = offset
        self._nbytes = nbytes
        self._refs = 1
        self._digest: Optional[LeaseDigest] = None

    # -- identity ----------------------------------------------------------
    @property
    def arena(self) -> "ShmArena":
        return self._arena

    @property
    def family(self) -> str:
        return self._region.family

    @property
    def region_name(self) -> str:
        return self._region.name

    @property
    def region_key(self) -> str:
        return self._region.key

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def byte_size(self) -> int:
        """The slab's class size (the lease may use only a prefix of it)."""
        return self._region.class_bytes

    @property
    def nbytes(self) -> int:
        """Bytes actually staged/requested (<= byte_size)."""
        return self._nbytes

    @property
    def released(self) -> bool:
        return self._refs <= 0

    def __repr__(self) -> str:
        return (f"ArenaLease(region={self.region_name!r}, offset={self._offset}"
                f", class={self.byte_size}, nbytes={self._nbytes}, "
                f"refs={self._refs})")

    # -- integrity seal ----------------------------------------------------
    def seal_digest(self, nbytes: Optional[int] = None) -> LeaseDigest:
        """Seal the slab's current contents (first ``nbytes``, default the
        staged span) under a :class:`LeaseDigest`; every later
        ``as_numpy`` re-verifies it before mapping. A local ``write*``
        drops the seal (the holder mutating its own slab is not
        corruption)."""
        self._digest = LeaseDigest.seal(self, nbytes)
        return self._digest

    def digest(self) -> Optional[LeaseDigest]:
        return self._digest

    # -- refcount ----------------------------------------------------------
    def retain(self) -> "ArenaLease":
        self._arena._retain(self)
        return self

    def release(self) -> None:
        self._arena._release(self)

    # -- data --------------------------------------------------------------
    def _check_live(self) -> None:
        if self._refs <= 0:
            raise ArenaLeaseReleased(
                f"arena lease on {self.region_name!r}@{self._offset} was "
                "released; the slab may already back another lease")

    def _check_span(self, nbytes: int, offset: int, op: str) -> None:
        if offset < 0 or nbytes < 0 or offset + nbytes > self.byte_size:
            raise ArenaError(
                f"arena lease {op} of {nbytes}B at offset {offset} exceeds "
                f"the {self.byte_size}B slab")

    def memoryview(self) -> memoryview:
        """A writable view of the whole slab (zero-copy). On cuda-family
        regions, overlapping device entries are flushed into the window
        and dropped first, so the raw view is coherent both ways."""
        self._check_live()
        base = self._offset
        if self._region.family == "cuda":
            self._region.handle._flush_overlapping(base, self.byte_size)
        return self._region._host_view()[base: base + self.byte_size]

    def _pre_host_write(self, base: int, nbytes: int) -> None:
        # cuda-family regions: a pinned device entry is authoritative over
        # its host range — drop overlapping entries so a direct host write
        # cannot be shadowed (or later clobbered by a flush) by stale
        # device bytes from a previous occupant of this slab
        if self._region.family == "cuda":
            self._region.handle._invalidate_overlapping(base, nbytes)

    def _pre_host_read(self, base: int, nbytes: int) -> None:
        # the mirror of _pre_host_write: materialize overlapping device
        # entries into the host window before a host-side read
        if self._region.family == "cuda":
            self._region.handle._flush_overlapping(base, nbytes)

    def write(self, data, offset: int = 0) -> int:
        """Copy ``data`` (bytes-like) into the slab; returns bytes written."""
        self._check_live()
        self._digest = None  # a local write invalidates the seal
        data = memoryview(data).cast("B")
        self._check_span(len(data), offset, "write")
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_map(self.family, write=True)
        base = self._offset + offset
        self._pre_host_write(base, len(data))
        self._region._host_view()[base: base + len(data)] = data
        if offset + len(data) > self._nbytes:
            self._nbytes = offset + len(data)
        return len(data)

    def write_numpy(self, arr, offset: int = 0) -> int:
        """Serialize a host array into the slab with ONE write (fixed-width
        dtypes are copied directly into the mapping; BYTES/BF16 serialize
        first). Returns bytes written."""
        self._check_live()
        arr = np.asarray(arr)
        if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
            s = serialize_byte_tensor(arr)
            return self.write(s.item() if s.size else b"", offset)
        if arr.dtype == np.dtype(triton_to_np_dtype("BF16")) and \
                arr.dtype != np.float32:
            return self.write(serialize_bf16_tensor(arr).item(), offset)
        nbytes = arr.nbytes
        self._check_span(nbytes, offset, "write")
        self._digest = None  # a local write invalidates the seal
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_map(self.family, write=True)
        base = self._offset + offset
        self._pre_host_write(base, nbytes)
        dst = np.frombuffer(self._region._host_view(), dtype=np.uint8,
                            count=nbytes, offset=base)
        np.copyto(dst, np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
        if offset + nbytes > self._nbytes:
            self._nbytes = offset + nbytes
        return nbytes

    def write_torch(self, tensor: torch.Tensor, offset: int = 0) -> int:
        """Bind a torch tensor at the lease's slab (cuda-family regions
        only): pins it in the region's cache and mirrors to host unless the
        region is colocated. Returns bytes written."""
        self._check_live()
        self._digest = None  # a local write invalidates the seal
        if self.family != "cuda":
            raise ArenaError("write_torch needs a cuda-family lease")
        from .utils.cuda_shared_memory import set_shared_memory_region_from_torch

        nbytes = tensor.element_size() * tensor.numel()
        self._check_span(nbytes, offset, "write")
        set_shared_memory_region_from_torch(
            self._region.handle, tensor, self._offset + offset)
        if offset + nbytes > self._nbytes:
            self._nbytes = offset + nbytes
        return nbytes

    def as_numpy(self, datatype, shape, offset: int = 0) -> np.ndarray:
        """Decode the slab contents as ``datatype``/``shape``.

        Fixed-width dtypes return a ZERO-COPY view over the mapped region —
        the view is valid only while the lease is held, and requesting it
        after the last ``release()`` raises :class:`ArenaLeaseReleased`.
        BYTES/BF16 decode (one copy, as everywhere else).
        """
        self._check_live()
        if self._digest is not None:
            # sealed lease: re-verify the server's answer before mapping
            # (a post-answer scribble raises typed, never aliases garbage)
            self._digest.verify(self)
        if isinstance(datatype, str):
            triton_dtype = datatype
            np_dtype = (np.dtype(np.object_) if datatype == "BYTES"
                        else np.dtype(triton_to_np_dtype(datatype)))
        else:
            np_dtype = np.dtype(datatype)
            triton_dtype = "BYTES" if np_dtype == np.object_ else None
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_map(self.family, write=False)
        n_elems = int(np.prod(shape)) if len(shape) else 1
        base = self._offset + offset
        if triton_dtype == "BYTES":
            from .utils import deserialize_bytes_tensor

            span = self._offset + self.byte_size - base
            self._pre_host_read(base, span)
            raw = bytes(self._region._host_view()[base: base + span])
            return deserialize_bytes_tensor(raw, count=n_elems).reshape(shape)
        if triton_dtype == "BF16":
            from .utils import deserialize_bf16_tensor

            self._pre_host_read(base, 2 * n_elems)
            raw = bytes(self._region._host_view()[base: base + 2 * n_elems])
            return deserialize_bf16_tensor(raw).reshape(shape)
        nbytes = n_elems * np_dtype.itemsize
        self._check_span(nbytes, offset, "read")
        self._pre_host_read(base, nbytes)
        return np.frombuffer(self._region._host_view(), dtype=np_dtype,
                             count=n_elems, offset=base).reshape(shape)

    def as_torch(self, datatype: str, shape, offset: int = 0,
                 device="cuda") -> torch.Tensor:
        """Device view of the slab (cuda-family; ``datatype`` a Triton
        string): cache hit = the pinned tensor, zero copies; miss = one H2D
        copy onto the region's device. The result is then placed on
        ``device`` (no copy where it is there already)."""
        self._check_live()
        if self.family != "cuda":
            raise ArenaError("as_torch needs a cuda-family lease")
        from .utils.cuda_shared_memory import get_contents_as_torch

        out = get_contents_as_torch(
            self._region.handle, datatype, shape, self._offset + offset)
        target = torch.device(device)
        if out.device.type != target.type or (
                target.index is not None and out.device != target):
            out = out.to(target)
        return out

    # -- request binding ---------------------------------------------------
    def bind_input(self, inp) -> Any:
        """Point an ``InferInput`` at this lease's slab (releases any
        OTHER lease the input previously held — re-binding the same lease
        is idempotent, not a self-release) and attach for
        registration-on-infer."""
        self._check_live()
        if getattr(inp, "_arena_lease", None) is self:
            inp._arena_lease = None  # set_shared_memory must not drop US
        inp.set_shared_memory(self.region_name, self._nbytes or self.byte_size,
                              self._offset)
        inp._arena_lease = self
        return inp

    def bind_output(self, out) -> Any:
        """Point an ``InferRequestedOutput`` at this lease's slab
        (re-binding the same lease is idempotent)."""
        self._check_live()
        if getattr(out, "_arena_lease", None) is self:
            out._arena_lease = None
        out.set_shared_memory(self.region_name, self.byte_size, self._offset)
        out._arena_lease = self
        return out


class ShmArena:
    """The pooled allocator over both shm util packages.

    One arena serves BOTH families: ``lease(nbytes, family="system")`` for
    POSIX host regions, ``family="cuda"`` for cuda host-window regions (with
    the arena's ``device_id``/``colocated``/``device`` settings; ``device``
    is ``"cuda"`` or, for CPU-only runs, ``"cpu"``). All public methods
    are thread-safe; lease/release never block beyond one short lock, so
    they are safe on asyncio event loops too.
    """

    def __init__(
        self,
        default_family: str = "system",
        min_class_bytes: int = _PAGE,
        max_class_bytes: int = 64 * 1024 * 1024,
        region_target_bytes: int = 1024 * 1024,
        max_slabs_per_region: int = 64,
        high_watermark_bytes: int = 256 * 1024 * 1024,
        low_watermark_bytes: int = 128 * 1024 * 1024,
        device_id: int = 0,
        colocated: bool = True,
        promote_inputs: bool = True,
        name_prefix: str = "arena",
        device: str = "cuda",
    ):
        if default_family not in ("system", "cuda"):
            raise ArenaError(f"unknown shm family {default_family!r}")
        if min_class_bytes <= 0 or max_class_bytes < min_class_bytes:
            raise ArenaError("invalid size-class bounds")
        if low_watermark_bytes > high_watermark_bytes:
            raise ArenaError("low watermark must not exceed the high one")
        self.default_family = default_family
        self.min_class_bytes = min_class_bytes
        self.max_class_bytes = max_class_bytes
        self.region_target_bytes = region_target_bytes
        self.max_slabs_per_region = max_slabs_per_region
        self.high_watermark_bytes = high_watermark_bytes
        self.low_watermark_bytes = low_watermark_bytes
        self.device_id = device_id
        self.colocated = colocated
        self.device = device
        self.promote_inputs = promote_inputs
        self.name_prefix = name_prefix
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        # (family, class_bytes) -> [(region, offset), ...] free slabs
        self._free: Dict[Tuple[str, int], List[Tuple[_ArenaRegion, int]]] = {}
        self._regions: List[_ArenaRegion] = []
        self._free_bytes = 0
        self._total_bytes = 0
        # (url, region name) registration cache + per-key issue locks
        self._registered: set = set()
        self._reg_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._stats = {
            "leases": 0, "releases": 0, "hits": 0, "misses": 0,
            "regions_created": 0, "regions_trimmed": 0,
            "registrations_issued": 0, "registrations_cached": 0,
            "registrations_invalidated": 0,
        }
        _ARENAS.add(self)

    # -- allocation --------------------------------------------------------
    def _class_for(self, nbytes: int) -> int:
        return _round_class(nbytes, self.min_class_bytes, self.max_class_bytes)

    def _carve_locked(self, family: str, class_bytes: int) -> _ArenaRegion:
        """Create one region carved into slabs of ``class_bytes`` (caller
        holds the lock; the mmap itself is microseconds)."""
        slabs = 1
        if class_bytes <= self.region_target_bytes:
            slabs = max(1, min(self.max_slabs_per_region,
                               self.region_target_bytes // class_bytes))
        name = f"{self.name_prefix}_{family}_{_uuid.uuid4().hex[:12]}"
        total = class_bytes * slabs
        if family == "system":
            from .utils import shared_memory as shm

            handle = shm.create_shared_memory_region(
                name, f"/{name}", total, create_only=True)
            key = f"/{name}"
        else:
            from .utils import cuda_shared_memory as cudashm

            handle = cudashm.create_shared_memory_region(
                name, total, device_id=self.device_id,
                colocated=self.colocated, device=self.device)
            key = handle.shm_key
        region = _ArenaRegion(family, name, key, class_bytes, slabs, handle,
                              self.device_id)
        self._regions.append(region)
        self._total_bytes += total
        self._free_bytes += total
        freelist = self._free.setdefault((family, class_bytes), [])
        for i in range(slabs):
            freelist.append((region, i * class_bytes))
        region.free_count = slabs
        self._stats["regions_created"] += 1
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_arena_carve(family, class_bytes, slabs)
        return region

    def lease(self, nbytes: int, family: Optional[str] = None) -> ArenaLease:
        """Lease one slab of the size class serving ``nbytes``.

        Returns an :class:`ArenaLease` holding ONE reference. A free slab
        of the class is a hit (no syscalls at all); a cold class carves a
        new region once and every subsequent lease hits."""
        if nbytes <= 0:
            raise ArenaError("lease size must be positive")
        family = family or self.default_family
        if family not in ("system", "cuda"):
            raise ArenaError(f"unknown shm family {family!r}")
        class_bytes = self._class_for(nbytes)
        with self._lock:
            if self._closed:
                raise ArenaError("arena is closed")
            freelist = self._free.get((family, class_bytes))
            if freelist:
                hit = True
            else:
                self._carve_locked(family, class_bytes)
                freelist = self._free[(family, class_bytes)]
                hit = False
            region, offset = freelist.pop()
            region.free_count -= 1
            region.leased += 1
            self._seq += 1
            region.last_used = self._seq
            self._free_bytes -= class_bytes
            self._stats["leases"] += 1
            self._stats["hits" if hit else "misses"] += 1
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_arena_lease(family, class_bytes, hit)
        _flight.note("arena", "lease", bytes=class_bytes, hit=hit)
        return ArenaLease(self, region, offset, nbytes)

    def _retain(self, lease: ArenaLease) -> None:
        with self._lock:
            if lease._refs <= 0:
                raise ArenaLeaseReleased(
                    "cannot retain a fully released arena lease")
            lease._refs += 1

    def _release(self, lease: ArenaLease) -> None:
        trim: List[_ArenaRegion] = []
        with self._lock:
            if lease._refs <= 0:
                raise ArenaError(
                    f"arena lease on {lease.region_name!r}@{lease.offset} "
                    "released more times than retained")
            lease._refs -= 1
            if lease._refs > 0:
                return
            region = lease._region
            # a freed slab must not carry its occupant's pinned device
            # tensors into the next lease (they would shadow/clobber fresh
            # host writes) — evict BEFORE the slab is published to the
            # free list, or a concurrent re-lease's write_torch pin could be
            # the thing we drop (lock order arena -> region handle is
            # taken nowhere in reverse)
            if region.family == "cuda":
                region.handle._invalidate_overlapping(
                    lease._offset, region.class_bytes)
            region.free_count += 1
            region.leased -= 1
            self._seq += 1
            region.last_used = self._seq
            self._free.setdefault((region.family, region.class_bytes), []) \
                .append((region, lease._offset))
            self._free_bytes += region.class_bytes
            self._stats["releases"] += 1
            if self._free_bytes > self.high_watermark_bytes:
                trim = self._collect_trim_locked(self.low_watermark_bytes)
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_arena_release(region.family, region.class_bytes)
        if trim:
            self._trim_async(trim)

    # -- trimming ----------------------------------------------------------
    def _collect_trim_locked(self, target_free_bytes: int) -> List[_ArenaRegion]:
        """Pick fully-free regions LRU-first until free bytes fall to the
        target; detach them from the arena's structures (caller destroys
        outside the lock)."""
        victims: List[_ArenaRegion] = []
        idle = sorted((r for r in self._regions if r.leased == 0),
                      key=lambda r: r.last_used)
        for region in idle:
            if self._free_bytes <= target_free_bytes:
                break
            self._regions.remove(region)
            freelist = self._free.get((region.family, region.class_bytes), [])
            self._free[(region.family, region.class_bytes)] = [
                slot for slot in freelist if slot[0] is not region]
            self._free_bytes -= region.byte_size
            self._total_bytes -= region.byte_size
            for url in region.registered:
                self._registered.discard((url, region.name))
            self._stats["regions_trimmed"] += 1
            victims.append(region)
        return victims

    def _trim_async(self, victims: List[_ArenaRegion]) -> None:
        """Watermark trims fire from ``release()``, which promises never to
        block (asyncio callers release on the event loop): the best-effort
        unregister RPCs and munmaps run on a short-lived daemon thread.
        The victims are already detached from every arena structure, so
        nothing can re-lease them meanwhile."""
        threading.Thread(
            target=self._destroy_regions, args=(victims,),
            name="shm-arena-trim", daemon=True).start()

    def _destroy_regions(self, regions: List[_ArenaRegion]) -> None:
        for region in regions:
            # best-effort server-side unregister everywhere this region was
            # registered (a dead client weakref or an async-only client just
            # means the server keeps a stale attach until its own cleanup)
            for url, ref in list(region.registered.items()):
                client = ref() if ref is not None else None
                if client is None:
                    continue
                unregister = getattr(
                    client,
                    "unregister_system_shared_memory"
                    if region.family == "system"
                    else "unregister_cuda_shared_memory", None)
                if unregister is None or asyncio.iscoroutinefunction(unregister):
                    continue
                try:
                    unregister(region.name)
                except Exception:
                    pass
            try:
                if region.family == "system":
                    from .utils import shared_memory as shm

                    shm.destroy_shared_memory_region(region.handle)
                else:
                    from .utils import cuda_shared_memory as cudashm

                    cudashm.destroy_shared_memory_region(region.handle)
            except Exception:
                pass
            rec = _observe._DATAPLANE
            if rec is not None:
                rec.on_arena_trim(region.family, region.class_bytes,
                                  region.slab_count)

    def trim(self, target_free_bytes: int = 0) -> int:
        """Destroy fully-free regions (LRU-first) until free bytes fall to
        ``target_free_bytes``; returns the number of regions destroyed."""
        with self._lock:
            victims = self._collect_trim_locked(target_free_bytes)
        self._destroy_regions(victims)
        return len(victims)

    def close(self, force: bool = False) -> None:
        """Destroy every region. Outstanding leases make this an error
        unless ``force=True`` (their views die with the mappings)."""
        with self._lock:
            leased = sum(r.leased for r in self._regions)
            if leased and not force:
                raise ArenaError(
                    f"cannot close arena: {leased} slab(s) still leased "
                    "(pass force=True to tear down anyway)")
            victims = list(self._regions)
            self._regions.clear()
            self._free.clear()
            self._free_bytes = 0
            self._total_bytes = 0
            self._registered.clear()
            self._reg_locks.clear()
            self._closed = True
        self._destroy_regions(victims)

    # -- cached server registrations ---------------------------------------
    @staticmethod
    def _endpoint_of(client) -> str:
        url = getattr(client, "_url", None)
        return url if url else f"anon:{id(client):x}"

    def _issue_register(self, client, region: _ArenaRegion):
        """The actual registration RPC (whole region, offset 0: every slab
        rides one registration)."""
        if region.family == "system":
            return client.register_system_shared_memory(
                region.name, region.key, region.byte_size)
        from .utils import cuda_shared_memory as cudashm

        return client.register_cuda_shared_memory(
            region.name, cudashm.get_raw_handle(region.handle),
            region.device_id, region.byte_size)

    def _note_cached(self) -> None:
        with self._lock:
            self._stats["registrations_cached"] += 1
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_arena_registration("cached")

    def _note_issued(self, url: str, region: _ArenaRegion, client) -> None:
        with self._lock:
            self._registered.add((url, region.name))
            try:
                region.registered[url] = weakref.ref(client)
            except TypeError:
                region.registered[url] = None
            self._stats["registrations_issued"] += 1
        rec = _observe._DATAPLANE
        if rec is not None:
            rec.on_arena_registration("issued")
        # a registration RPC on the request path is exactly the kind of
        # one-off stall a retained slow timeline should explain
        _flight.note("arena", "register", url=url, region=region.name)

    def is_registered(self, client, region_name: str) -> bool:
        with self._lock:
            return (self._endpoint_of(client), region_name) in self._registered

    def ensure_registered(self, client, region: _ArenaRegion) -> bool:
        """Make ``region`` usable against ``client``'s endpoint; the RPC is
        issued only on first use (True) — every later call is a cache hit
        (False, no network)."""
        url = self._endpoint_of(client)
        ck = (url, region.name)
        with self._lock:
            if ck in self._registered:
                cached = True
            else:
                cached = False
                issue_lock = self._reg_locks.setdefault(ck, threading.Lock())
        if cached:
            self._note_cached()
            return False
        with issue_lock:
            with self._lock:
                if ck in self._registered:
                    cached = True
            if cached:
                self._note_cached()
                return False
            try:
                self._issue_register(client, region)
            except Exception as e:
                # Triton semantics: re-registering an active name errors.
                # Region names are uuid-unique, so "already registered" can
                # only mean the server still holds OUR registration (e.g.
                # cache invalidated while the server kept state) — adopt it.
                if "already" not in str(e).lower():
                    raise
            self._note_issued(url, region, client)
        with self._lock:
            self._reg_locks.pop(ck, None)
        return True

    async def ensure_registered_async(self, client, region: _ArenaRegion) -> bool:
        """Asyncio twin of :meth:`ensure_registered` (optimistic: a rare
        concurrent first use may double-issue; the server's
        "already registered" answer is adopted as success)."""
        url = self._endpoint_of(client)
        ck = (url, region.name)
        with self._lock:
            if ck in self._registered:
                cached = True
            else:
                cached = False
        if cached:
            self._note_cached()
            return False
        try:
            await self._issue_register(client, region)
        except Exception as e:
            if "already" not in str(e).lower():
                raise
        self._note_issued(url, region, client)
        return True

    def invalidate_endpoint(self, url: str) -> int:
        """Drop every cached registration against ``url`` (the pool calls
        this on ejection; reconnect-class faults mean the server may have
        restarted and lost its registrations). Returns entries dropped."""
        with self._lock:
            dropped = [ck for ck in self._registered if ck[0] == url]
            for ck in dropped:
                self._registered.discard(ck)
            for region in self._regions:
                region.registered.pop(url, None)
            self._stats["registrations_invalidated"] += len(dropped)
        rec = _observe._DATAPLANE
        if rec is not None:
            for _ in dropped:
                rec.on_arena_registration("invalidated")
        return len(dropped)

    def _on_server_unregister(self, url: Optional[str], name: str) -> None:
        """A frontend reported a successful server-side unregister: drop the
        matching cache entries (name == "" unregisters ALL of that url's)."""
        if url is None:
            return
        with self._lock:
            if name:
                if (url, name) not in self._registered:
                    return
                dropped = [(url, name)]
            else:
                dropped = [ck for ck in self._registered if ck[0] == url]
            if not dropped:
                return
            for ck in dropped:
                self._registered.discard(ck)
            for region in self._regions:
                if not name or region.name == name:
                    region.registered.pop(url, None)
            self._stats["registrations_invalidated"] += len(dropped)
        rec = _observe._DATAPLANE
        if rec is not None:
            for _ in dropped:
                rec.on_arena_registration("invalidated")

    # -- convenience -------------------------------------------------------
    def stage(self, data, family: Optional[str] = None) -> ArenaLease:
        """Lease a slab sized for ``data`` (bytes-like) and write it in one
        call — the response cache (``client_tpu.cache``, not ported yet) stages each cached
        output's payload this way, so the entry outlives the wire buffer
        for exactly as long as the lease is held. The lease is released on
        a failed write (no slab can leak half-staged)."""
        view = memoryview(data).cast("B")
        lease = self.lease(max(len(view), 1), family=family)
        try:
            if len(view):
                lease.write(view)
        except BaseException:
            lease.release()
            raise
        return lease

    def request_output(self, name: str, nbytes: int,
                       family: Optional[str] = None):
        """An ``InferRequestedOutput`` backed by a fresh lease: the server
        writes the output into the slab and ``InferResult.as_numpy``
        returns a zero-copy view pinned by the lease."""
        from ._tensor import InferRequestedOutput

        lease = self.lease(nbytes, family=family)
        return lease.bind_output(InferRequestedOutput(name))

    # -- read side ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """JSON-ready counters + residency (the perf rows' arena hit rate
        and the doctor's leak check read this)."""
        with self._lock:
            s = dict(self._stats)
            s["leased_bytes"] = self._total_bytes - self._free_bytes
            s["free_bytes"] = self._free_bytes
            s["total_bytes"] = self._total_bytes
            s["regions"] = len(self._regions)
            s["leased_slabs"] = sum(r.leased for r in self._regions)
            denom = s["leases"]
            s["hit_rate"] = round(s["hits"] / denom, 4) if denom else None
            reg_total = (s["registrations_issued"]
                         + s["registrations_cached"])
            s["registration_cache_hit_rate"] = (
                round(s["registrations_cached"] / reg_total, 4)
                if reg_total else None)
            s["registration_cache_entries"] = len(self._registered)
        return s

    def inventory(self) -> List[Dict[str, Any]]:
        """One dict per region (the doctor's arena section)."""
        with self._lock:
            return [
                {"family": r.family, "name": r.name, "key": r.key,
                 "class_bytes": r.class_bytes, "slabs": r.slab_count,
                 "byte_size": r.byte_size, "leased_slabs": r.leased,
                 "free_slabs": r.free_count,
                 "registered_endpoints": sorted(r.registered)}
                for r in self._regions
            ]

    def registration_entries(self) -> Dict[str, List[str]]:
        """Cached registrations grouped per endpoint url."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            for url, name in sorted(self._registered):
                out.setdefault(url, []).append(name)
        return out


# live arenas (doctor inventory + server-unregister fan-out)
_ARENAS: "weakref.WeakSet[ShmArena]" = weakref.WeakSet()
_default_arena: Optional[ShmArena] = None
_default_lock = threading.Lock()


def _close_all_at_exit() -> None:
    """Arena regions deliberately outlive individual requests and runs, so
    unmap+unlink them at interpreter exit (otherwise the multiprocessing
    resource tracker warns about — and then unlinks — every one)."""
    for arena in arenas():
        try:
            arena.close(force=True)
        except Exception:
            pass


atexit.register(_close_all_at_exit)


def arenas() -> List[ShmArena]:
    """Every live arena in this process."""
    return list(_ARENAS)


def default_arena(**kwargs) -> ShmArena:
    """The process-default arena (created on first use; ``shm_arena=True``
    on a client resolves to it). ``kwargs`` configure the first creation
    only."""
    global _default_arena
    with _default_lock:
        if _default_arena is None or _default_arena._closed:
            _default_arena = ShmArena(**kwargs)
        return _default_arena


def notify_unregister(url: Optional[str], name: str = "") -> None:
    """Called by the frontends after a successful server-side unregister
    RPC so every arena's registration cache stops assuming the region is
    still registered there."""
    for arena in arenas():
        arena._on_server_unregister(url, name)


# -- request binding (the frontends' transparent fast path) -------------------
_SHM_PARAM_KEYS = ("shared_memory_region", "shared_memory_byte_size",
                   "shared_memory_offset")


class _BoundRequest:
    """Per-request arena bookkeeping handed back to the frontend: restores
    promoted inputs and releases their transient leases after the response
    (``settle``), and attaches user-leased output leases to the result
    (``finish``) so ``as_numpy`` can serve zero-copy views."""

    __slots__ = ("_promoted", "_out_leases", "_seal_digests")

    def __init__(self):
        self._promoted: List[Tuple[Any, Any, ArenaLease]] = []
        self._out_leases: Optional[Dict[str, ArenaLease]] = None
        self._seal_digests = False

    def finish(self, result) -> None:
        if self._out_leases:
            result._arena_output_leases = dict(self._out_leases)
            if self._seal_digests:
                # seal each output slab the moment the response lands:
                # as_numpy re-verifies, so a server scribbling after its
                # answer raises typed instead of aliasing garbage
                for lease in self._out_leases.values():
                    if not lease.released:
                        lease.seal_digest()

    def settle(self) -> None:
        for inp, raw, lease in self._promoted:
            for key in _SHM_PARAM_KEYS:
                inp._parameters.pop(key, None)
            inp._raw_data = raw
            try:
                lease.release()
            except ArenaError:
                pass
        self._promoted = []


def _promote_input(arena: ShmArena, inp, raw) -> Tuple[ArenaLease, Any]:
    """Stage an input's already-serialized binary payload into a slab and
    swap its wire representation to shm params (restored by settle)."""
    lease = arena.lease(len(raw), family=arena.default_family)
    try:
        lease.write(raw)
    except BaseException:
        lease.release()
        raise
    inp._raw_data = None
    inp._parameters["shared_memory_region"] = lease.region_name
    inp._parameters["shared_memory_byte_size"] = len(raw)
    if lease.offset:
        inp._parameters["shared_memory_offset"] = lease.offset
    inp._parameters.pop("binary_data_size", None)
    return lease, raw


def _collect(client, arena: Optional[ShmArena], inputs, outputs,
             promote: bool):
    """Shared scan: (ensure list of (arena, region), ctx or None)."""
    # validation pass BEFORE any mutation: a released lease's slab may
    # already back another live lease, so refusing here turns silent
    # cross-request corruption into the typed error (reusing a request
    # object after release_arena/release_arena_lease requires re-staging)
    # — and raising before promotion means no transient lease can leak
    for tensor in list(inputs) + list(outputs or ()):
        lease = getattr(tensor, "_arena_lease", None)
        if lease is not None:
            lease._check_live()
    ctx: Optional[_BoundRequest] = None
    ensure: List[Tuple[ShmArena, _ArenaRegion]] = []
    for inp in inputs:
        lease = getattr(inp, "_arena_lease", None)
        if lease is not None:
            ensure.append((lease.arena, lease._region))
            continue
        if not promote or arena is None or not arena.promote_inputs:
            continue
        raw = getattr(inp, "_raw_data", None)
        if not raw:
            continue
        lease, saved = _promote_input(arena, inp, raw)
        ensure.append((arena, lease._region))
        if ctx is None:
            ctx = _BoundRequest()
        ctx._promoted.append((inp, saved, lease))
    for out in outputs or ():
        lease = getattr(out, "_arena_lease", None)
        if lease is None:
            continue
        ensure.append((lease.arena, lease._region))
        if ctx is None:
            ctx = _BoundRequest()
        if ctx._out_leases is None:
            ctx._out_leases = {}
        ctx._out_leases[out.name()] = lease
    if ctx is not None and ctx._out_leases:
        # opt-in data-plane digests: seal output slabs at finish time
        # when the owning client's integrity policy asks for them
        policy_of = getattr(client, "integrity_policy", None)
        if policy_of is not None:
            policy = policy_of()
            ctx._seal_digests = policy is not None and policy.digests
    return ensure, ctx


def bind_request(client, arena: Optional[ShmArena], inputs, outputs,
                 promote: bool = True) -> Optional[_BoundRequest]:
    """Bind one outgoing request to the arena data plane (sync frontends):
    promote staged binary inputs into leases, and make sure every touched
    region is registered against this client's endpoint (cached after the
    first RPC). Returns None when the request touches no arena state."""
    ensure, ctx = _collect(client, arena, inputs, outputs, promote)
    try:
        for owner, region in ensure:
            owner.ensure_registered(client, region)
    except BaseException:
        if ctx is not None:
            ctx.settle()
        raise
    return ctx


async def bind_request_async(client, arena: Optional[ShmArena], inputs,
                             outputs, promote: bool = True
                             ) -> Optional[_BoundRequest]:
    """Asyncio twin of :func:`bind_request` for the aio frontends."""
    ensure, ctx = _collect(client, arena, inputs, outputs, promote)
    try:
        for owner, region in ensure:
            await owner.ensure_registered_async(client, region)
    except BaseException:
        if ctx is not None:
            ctx.settle()
        raise
    return ctx
