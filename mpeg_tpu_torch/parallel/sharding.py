"""Multi-stream data parallelism over a list of torch devices.

Port of `mpeg_tpu/parallel/sharding.py`.  Independent MPEG streams are
embarrassingly parallel: the stream axis splits contiguously over the
mesh's devices (S / len(devices) streams a device, as the reference's
`P("streams")` does), each device decodes its own shard, and the only
collective is a sum of the decoded pixel (or sample) counts — in int64,
and `all_reduce`d over the process group when `torch.distributed` is
initialized (`parallel.multihost` runs one process a host).

A mesh is a plain list of devices.  Entries may repeat: `["cpu"] * 4`
rehearses four devices on the CPU, `["cuda:0", "cuda:0"]` two on one
card.  Shards live where their device is; carries, displays and audio
history are lists with one tensor a shard, and `torch.cat` of a list
(on one device) is the reference's global array.

Transports mirror `parallel.batch`: window-pool blobs, one a stream
(`make_sharded_blob_decoder`), and stacked dense plans
(`make_sharded_scan_decoder`, the readable oracle); each shard is one
stream-batched program, as the reference's `vmap` over its streams.
Audio shards the same way (`make_sharded_audio_synth`, one K4 launch a
shard).

Every shard's work is enqueued before any result is waited on, so that
shards on several cards overlap.  Each decoder stages the caller's
blobs, plans or samples into pinned host buffers of its own (a
`batch.HostRing` a device: two in rotation, each written again only
once the copy that last read it has completed) and copies each shard
asynchronously on its device's copy stream (`batch.device_put`):
nothing waits for a card, and the caller may reuse its arrays as soon
as a call returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import explicit_device
from ..ops.cuda_kernels import synthesize
from ..ops.video_recon import FrameGeometry
from .batch import (
    _DENSE_RING, _PLAN_FIELDS, HostRing, _dense_flags, blob_layout,
    blob_split, densify_unpack, pack_plans_blob, put_stacks, stack_plans,
)
from .multistream import GlobalWindowDecoder


@dataclass(frozen=True)
class Mesh:
    """The devices of one process's stream shards, in stream order, and
    the process group their counts are summed over (None outside
    `torch.distributed`)."""

    devices: tuple
    axis: str = "streams"
    group: object = None

    def split(self, n_streams: int) -> list:
        """(device, first stream, end stream) of each shard."""
        n_dev = len(self.devices)
        if n_streams % n_dev:
            raise ValueError(f"{n_streams} streams do not split over "
                             f"{n_dev} devices")
        per = n_streams // n_dev
        return [(d, i * per, (i + 1) * per)
                for i, d in enumerate(self.devices)]


def make_mesh(devices=None, axis: str = "streams") -> Mesh:
    """A mesh of `devices` (default: every CUDA device; it raises without
    one).  Entries are normalized to explicit indices ("cuda" becomes
    "cuda:i" of the current device) and may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): CUDA is not available; pass "
                               "devices (e.g. [\"cpu\"] * 4) to rehearse "
                               "on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(explicit_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh(): no devices")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"{d}: the machine has "
                             f"{torch.cuda.device_count()} CUDA devices")
    import torch.distributed as dist
    group = dist.group.WORLD \
        if dist.is_available() and dist.is_initialized() else None
    return Mesh(devs, axis, group)


def _reduce_count(n: int, mesh: Mesh) -> torch.Tensor:
    """The int64 sum of this process's count `n` over the mesh's process
    group: a 0-d tensor on the mesh's first device under NCCL (filled on
    the card, so nothing waits), else on the CPU."""
    if mesh.group is None:
        return torch.tensor(n, dtype=torch.int64)
    import torch.distributed as dist
    dev = mesh.devices[0] if dist.get_backend(mesh.group) == "nccl" \
        else torch.device("cpu")
    total = torch.full((), n, dtype=torch.int64, device=dev)
    dist.all_reduce(total, group=mesh.group)
    return total


def _shards_by_device(layout) -> dict:
    """device -> the indices of its shards in `layout` (`Mesh.split`)."""
    on_device = {}
    for i, (d, _a, _b) in enumerate(layout):
        on_device.setdefault(d, []).append(i)
    return on_device


def zero_carry(geom: FrameGeometry, n_streams: int, mesh: Mesh):
    """(current, forward, backward): three distinct lists, each with one
    zeroed uint8 [S_d, total_size] tensor a shard, on its device."""
    return tuple(
        [torch.zeros((b - a, geom.total_size), dtype=torch.uint8, device=d)
         for d, a, b in mesh.split(n_streams)]
        for _ in range(3))


def _n_streams(carry) -> int:
    return sum(c.shape[0] for c in carry[0])


def make_sharded_blob_decoder(geom: FrameGeometry, mesh: Mesh, window: int,
                              km: int, ke: int):
    """Multi-stream decoder over window-pool blobs, one a stream.

    decode(carry, blobs uint8 [S, bytes]) -> (carry', displays, total_px):
    `blobs` on the host (numpy, as `stack_stream_blobs` packs them), each
    at the (km, ke) buckets; `displays` one uint8 [S_d, window,
    total_size] tensor a shard; `total_px` the decoded pixels of every
    stream (int64, summed over the process group).

    The blobs of each device's shards are staged into one pinned buffer
    of the decoder's `batch.HostRing` for that device (one ring a device,
    however often the mesh lists it) and each shard's rows are
    copied asynchronously on the device's copy stream; each shard then
    densifies and unpacks all its streams in one `densify_unpack` (K5's
    three launches on the card, after the copy's gate), and runs one
    stream-batched K1 launch a step over its streams
    (`GlobalWindowDecoder.reconstruct`: a frame pool of four frames a
    stream and a slot table rotated on the host).  The call waits for no
    card, and `blobs` may be reused as soon as it returns."""
    offs, total = blob_layout(geom, window, km, ke)
    split = blob_split(geom, window, km, ke)
    flags_off = offs["flags"][0]
    shards = {}   # (device, streams) -> GlobalWindowDecoder
    staging = {}  # device -> HostRing of its shards' blobs

    def decode_shard(dec, carry_d, dev_blobs, flags):
        coeffs, meta = densify_unpack(
            dev_blobs[:, :split], dev_blobs[:, split:], geom, window, km, ke,
            dec.premult, dec.nb_class_rep)
        plan = [coeffs, *(meta[k] for k in _PLAN_FIELDS)]
        return _pooled_window(dec, carry_d, plan, flags)

    def decode(carry, blobs):
        blobs = np.ascontiguousarray(blobs, dtype=np.uint8)
        if blobs.ndim != 2 or blobs.shape[1] != total:
            raise ValueError(f"blobs: expected uint8 [S, {total}], got "
                             f"{blobs.shape}")
        layout = mesh.split(blobs.shape[0])
        if blobs.shape[0] != _n_streams(carry):
            raise ValueError(f"{blobs.shape[0]} blobs for "
                             f"{_n_streams(carry)} carried streams")
        flags = np.ascontiguousarray(
            blobs[:, flags_off:flags_off + 4 * window]).view(np.int32)
        # Every shard's copy first, one staging buffer a device.
        on_device = _shards_by_device(layout)
        dev_blobs = [None] * len(layout)
        for d, shard_ids in on_device.items():
            if d not in staging:
                staging[d] = HostRing(d)
            copies = staging[d].put([blobs[layout[i][1]:layout[i][2]]
                                     for i in shard_ids])
            for i, dev_blob in zip(shard_ids, copies):
                dev_blobs[i] = dev_blob
        outs = []
        for i, (d, a, b) in enumerate(layout):
            key = (d, b - a)
            if key not in shards:
                shards[key] = GlobalWindowDecoder(
                    geom, b - a, window, km, ke, chunks=1).to(d)
            outs.append(decode_shard(
                shards[key], [c[i] for c in carry], dev_blobs[i],
                flags[a:b].reshape(-1)))
        px = int(np.count_nonzero(flags & 2)) * geom.frame_size
        return _gather(outs) + (_reduce_count(px, mesh),)

    return decode


def _pooled_window(dec: GlobalWindowDecoder, carry_d, plan, flags):
    """One shard's window through the pooled step engine: the carry's
    three [S_d, total_size] frames go into a pool of four frames a stream,
    and come back out as three new tensors after the window."""
    cur, fwd, bwd = carry_d
    s_d = cur.shape[0]
    pool = torch.cat([cur, fwd, bwd, torch.empty_like(cur)])
    slots = np.arange(4 * s_d, dtype=np.int64).reshape(4, s_d).T.copy()
    (pool, slots), disps = dec.reconstruct((pool, slots), plan, flags)
    index, = dec.to_device(pool.device, slots[:, :3].T)
    return tuple(pool[index[k]] for k in range(3)), disps


def _gather(outs):
    """[(carry_d, displays_d)] -> (carry as three lists, displays list)."""
    carry = tuple([o[0][k] for o in outs] for k in range(3))
    return carry, [o[1] for o in outs]


def make_sharded_scan_decoder(geom: FrameGeometry, mesh: Mesh):
    """The dense variant: decode(carry, plans) with `plans` the stacked
    dense dict [S, T, ...] (`stack_stream_plans`), stream-major, on the
    host.  Returns (carry', displays, total_px) as the blob decoder does.

    As the reference vmaps its scan over a shard's streams, each shard is
    one program: its rows of every field are staged, in the stack layout
    of its S_d * T pictures (`batch.put_stacks`), into one pinned buffer
    of the decoder's ring for its device (at most `_DENSE_RING` buffers;
    one ring a device, however often the mesh lists it) and copied
    asynchronously as one part; then one stream-batched K1 launch a step
    over its streams (`GlobalWindowDecoder.reconstruct`, as the blob
    decoder runs it, with nothing to densify).  The call waits for no
    card, and `plans` may be reused as soon as it returns."""
    shards = {}   # (device, streams, steps) -> GlobalWindowDecoder
    staging = {}  # device -> HostRing of its shards' stacks

    def decode(carry, plans):
        flags = _dense_flags(plans)
        if flags.ndim != 2:
            raise ValueError(f"plans: expected [S, T, ...] fields, got "
                             f"is_noop of shape {flags.shape}")
        n, steps = flags.shape
        if n != _n_streams(carry):
            raise ValueError(f"plans of {n} streams for "
                             f"{_n_streams(carry)} carried streams")
        layout = mesh.split(n)
        # Every shard's copy first, one staging buffer a device.
        on_device = _shards_by_device(layout)
        fields = [None] * len(layout)
        for d, shard_ids in on_device.items():
            if d not in staging:
                staging[d] = HostRing(d, cap=_DENSE_RING)
            copies = put_stacks(staging[d], [
                {k: v[layout[i][1]:layout[i][2]] for k, v in plans.items()}
                for i in shard_ids], geom)
            for i, f in zip(shard_ids, copies):
                fields[i] = f
        outs = []
        for i, (d, a, b) in enumerate(layout):
            key = (d, b - a, steps)
            if key not in shards:
                # reconstruct reads no blob: the smallest pool buckets.
                shards[key] = GlobalWindowDecoder(
                    geom, b - a, steps, 1, 1, chunks=1).to(d)
            plan = [fields[i][k] for k in ("coeffs", *_PLAN_FIELDS)]
            outs.append(_pooled_window(shards[key], [c[i] for c in carry],
                                       plan, flags[a:b].reshape(-1)))
        px = int(np.count_nonzero(flags & 2)) * geom.frame_size
        return _gather(outs) + (_reduce_count(px, mesh),)

    return decode


def stack_stream_plans(per_stream_plans, geom: FrameGeometry, window: int):
    """[stream][(plan, type)] -> stream-major stacked dense plan dict
    [S, T, ...]."""
    stacked = [stack_plans(p, geom, window) for p in per_stream_plans]
    return {k: np.stack([s[k] for s in stacked]) for k in stacked[0]}


def stack_stream_blobs(per_stream_plans, geom: FrameGeometry, window: int,
                       km: int, ke: int) -> np.ndarray:
    """[stream][(plan, type)] -> window-pool blobs [S, total_bytes]."""
    return np.stack([pack_plans_blob(p, geom, window, km, ke)
                     for p in per_stream_plans])


# --------------------------------------------------------------------------
# Audio on the mesh
# --------------------------------------------------------------------------

def make_sharded_audio_synth(mesh: Mesh):
    """Multi-stream MP2 synthesis over the mesh.

    synth(samples [S, T, 2, 32] int32, hist) -> (u, hist', total):
    `samples` on the host (numpy or a CPU tensor), T a multiple of 16 (4n
    whole frames, see `filterbank.synthesize_window`); `hist`, `u` and
    `hist'` lists with one tensor a shard (f32 [S_d, 15, 2, 64] and
    [S_d, T, 2, 32]); `total` the int64 count of output samples a channel
    over every stream, summed over the process group.  Each device's
    shards are staged into one pinned buffer of the synth's
    `batch.HostRing` for that device and each shard's rows copied
    asynchronously, as the blob decoder's are; each shard then runs one
    K4 launch over its streams (`cuda_kernels.synthesize`; on the CPU the
    plain `filterbank.synthesize_window` a stream).  The call waits for
    no card, and `samples` may be reused as soon as it returns.
    Normalization stays with `filterbank.finalize`, which divides by a
    tensor on u's device (the exact IEEE quotient)."""

    staging = {}  # device -> HostRing of its shards' samples

    def synth(samples, hist):
        samples = np.asarray(samples, np.int32)
        if samples.ndim != 4 or samples.shape[2:] != (2, 32):
            raise ValueError(f"samples: expected [S, T, 2, 32], got "
                             f"{samples.shape}")
        layout = mesh.split(samples.shape[0])
        # Every shard's copy first, one staging buffer a device.
        on_device = _shards_by_device(layout)
        dev_samples = [None] * len(layout)
        for d, shard_ids in on_device.items():
            if d not in staging:
                staging[d] = HostRing(d)
            copies = staging[d].put([samples[layout[i][1]:layout[i][2]]
                                     for i in shard_ids])
            for i, x in zip(shard_ids, copies):
                dev_samples[i] = x
        us, hists = [], []
        for x, h in zip(dev_samples, hist):
            u, h = synthesize(x, h)
            us.append(u)
            hists.append(h)
        n = samples.shape[0] * samples.shape[1] * 32
        return us, hists, _reduce_count(n, mesh)

    return synth


def zero_audio_hist(n_streams: int, mesh: Mesh) -> list:
    """One zeroed f32 [S_d, 15, 2, 64] history a shard."""
    return [torch.zeros((b - a, 15, 2, 64), dtype=torch.float32, device=d)
            for d, a, b in mesh.split(n_streams)]
