"""Bit-plane register packing for host->device bank uploads.

The HLL register alphabet of a real bank is tiny - a zero bin plus a band
around log2(n/m), typically 10-20 distinct values (ops/screen.bank_values)
- so 8-bit registers carry 4-6 bits of index. Shipping k bit-planes of the
value INDEX instead of raw bytes cuts transfer bytes to k/8 of dense
(k = ceil(log2(len(values)))). The engines pack whenever plan_pack
returns a plan: on an H100 host the native threaded gather+pack beats the
raw path's numpy row gather (parallel/screened.upload_sorted_rows).

  pack:   host, numpy - idx = lut256[regs]; plane j = packbits of bit j
          (little bit order), (S, k, R/8) uint8.
  unpack: device, one jitted pass - bits regroup by broadcast shift/and
          (static shapes, elementwise), regs = table[idx] via jnp.take,
          placed into the donated upload buffer.

Roundtrip is bit-exact for any alphabet (tests/test_screen.py); decode
cost is a few linear passes over the slab in device memory.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


_native_pack_broken = False


def plan_pack(values):
    """(lut256, table, k) for a present-value alphabet, or None when
    packing cannot save wire bytes (k >= 8).

    lut256: uint8 value -> index map (absent values map to 0; callers
    only feed values from the alphabet). table: uint8 (2^k,) index ->
    value, zero-padded."""
    vals = sorted(int(v) for v in values)
    if not vals or vals[-1] > 255:
        return None
    k = max(1, int(np.ceil(np.log2(max(len(vals), 2)))))
    if k >= 8:
        return None
    lut256 = np.zeros(256, np.uint8)
    for i, v in enumerate(vals):
        lut256[v] = i
    table = np.zeros(1 << k, np.uint8)
    table[: len(vals)] = vals
    return lut256, table, k


def pack_rows(rows, lut256, k, out=None, scratch=None):
    """(S, R) uint8 registers -> (S, k, R//8) uint8 bit-planes (R must be
    a multiple of 8; every HLL m = 2^p qualifies).

    scratch: optional dict reused across calls - on lazily-backed VM
    hosts every fresh multi-hundred-MB temporary costs first-touch page
    faults, so the index and bit temporaries live in caller-held arenas
    (same trick as the upload gather arenas)."""
    s, r = rows.shape
    if out is None:
        out = np.empty((s, k, r // 8), np.uint8)
    # Prefer the native single-pass packer (one read of the slab; the
    # numpy form below re-streams it ~4x per plane through this host's
    # slow lazily-backed DRAM - measured 4.4 s vs ~0.5 s per 128 MiB).
    global _native_pack_broken
    if (not _native_pack_broken and rows.flags.c_contiguous
            and out.flags.c_contiguous):
        try:
            from ..native import fastx

            return fastx.pack_bitplanes(rows, lut256, k, out)
        except (ImportError, OSError):
            _native_pack_broken = True
    if scratch is None:
        scratch = {}
    idx = scratch.get("idx")
    if idx is None or idx.shape[0] < s or idx.shape[1] != r:
        idx = scratch["idx"] = np.empty((s, r), np.uint8)
        scratch["tmp"] = np.empty((s, r // 8), np.uint64)
    tmp = scratch["tmp"][:s]
    iv = idx[:s]
    np.take(lut256, rows, out=iv)
    # Bit-gather via u64 multiply: for each 8-value group (one LE u64
    # word u), bit j of each byte collects into one output byte as
    # ((u >> j) & 0x0101..) * 0x0102040810204080 >> 56 - cross terms
    # land outside bits 56..63 exactly (classic SWAR gather), matching
    # np.packbits(bitorder="little") bit-for-bit at ~10x less memory
    # traffic than the per-plane packbits form (no (S, R) bit temp).
    u = iv.view(np.uint64)
    m1 = np.uint64(0x0101010101010101)
    m2 = np.uint64(0x0102040810204080)
    for j in range(k):
        np.right_shift(u, np.uint64(j), out=tmp)
        np.bitwise_and(tmp, m1, out=tmp)
        np.multiply(tmp, m2, out=tmp)
        np.right_shift(tmp, np.uint64(56), out=tmp)
        out[:, j] = tmp  # narrowing copy to uint8
    return out


def gather_pack_rows(bank, rows, lut256, k, out=None, scratch=None):
    """pack_rows of bank[rows] without materializing the gathered slab:
    the native fused gather+pack reads each bank row exactly once;
    without the library it falls back to np.take + pack_rows (same
    bytes, two extra DRAM streams)."""
    if out is None:
        out = np.empty((len(rows), k, bank.shape[1] // 8), np.uint8)
    global _native_pack_broken
    if (not _native_pack_broken and bank.flags.c_contiguous
            and out.flags.c_contiguous):
        try:
            from ..native import fastx

            return fastx.gather_pack_bitplanes(bank, rows, lut256, k, out)
        except (ImportError, OSError):
            _native_pack_broken = True
    if scratch is None:
        scratch = {}
    ga = scratch.get("gather")
    if ga is None or ga.shape[0] < len(rows) or ga.shape[1] != bank.shape[1]:
        ga = scratch["gather"] = np.empty((len(rows), bank.shape[1]),
                                          np.uint8)
    np.take(bank, rows, axis=0, out=ga[: len(rows)])
    return pack_rows(ga[: len(rows)], lut256, k, out=out, scratch=scratch)


@partial(jax.jit, donate_argnums=(0,), static_argnames=("k",))
def unpack_place(buf, packed, table, i0, k):
    """Donated-buffer twin of screened._place_rows for packed slabs:
    decode (S, k, R/8) planes to (S, R) uint8 via the value table and
    place at row i0. Returns (buf, token) like _place_rows."""
    s = packed.shape[0]
    r8 = packed.shape[2]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    idx = jnp.zeros((s, r8 * 8), jnp.uint8)
    for j in range(k):
        bits = (packed[:, j, :, None] >> shifts) & jnp.uint8(1)
        idx = idx | (bits.reshape(s, r8 * 8) << j)
    rows = jnp.take(table, idx, axis=0)
    out = jax.lax.dynamic_update_slice(buf, rows, (i0, jnp.int32(0)))
    return out, out[i0, 0].astype(jnp.int32)
