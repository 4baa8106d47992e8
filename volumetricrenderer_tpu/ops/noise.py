"""Procedural 3D noise in pure JAX — the replacement for the
reference's vendored FastNoise2 C++/SIMD library (TestMain.cpp:43-62 uses
CellularDistance, Perlin, Simplex via FastNoise::New<...>/GenUniformGrid3D).

All generators are seeded, deterministic, fully vectorized (no Python loops
over voxels), and jit-friendly: a whole density grid is produced on-device
as one fused XLA program. Exact FastNoise2 bit-parity is NOT a goal — the
reference pipeline min-max-normalizes every channel (TestMain.cpp:64-78), so
any affine difference in raw noise range is absorbed downstream.

API: each generator maps float coordinates (already multiplied by frequency)
plus an integer seed to values roughly in [-1, 1].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "perlin3",
    "simplex3",
    "cellular3",
    "fbm3",
    "noise_grid",
]

_U32 = jnp.uint32

# Large odd constants for coordinate mixing (xxHash / FNV style).
_PRIME_X = _U32(0x9E3779B1)
_PRIME_Y = _U32(0x85EBCA77)
_PRIME_Z = _U32(0xC2B2AE3D)
_PRIME_S = _U32(0x27D4EB2F)


def _hash3(ix, iy, iz, seed):
    """Avalanche hash of 3 int32 lattice coords + seed -> uint32."""
    h = (
        ix.astype(_U32) * _PRIME_X
        ^ iy.astype(_U32) * _PRIME_Y
        ^ iz.astype(_U32) * _PRIME_Z
        ^ jnp.asarray(seed, _U32) * _PRIME_S
    )
    h = h * _U32(0x846CA68B)
    h = h ^ (h >> 16)
    h = h * _U32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * _U32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _hash_to_unit(h):
    """uint32 -> float32 in [0, 1)."""
    return h.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


def _grad_dot(ix, iy, iz, dx, dy, dz, seed):
    """Dot product of the hashed lattice gradient with offset (dx,dy,dz).

    Uses arithmetic selection instead of a table gather, so the whole
    thing fuses into elementwise code."""
    h = _hash3(ix, iy, iz, seed)
    # Pick gradient component signs/zeros from hash bits — equivalent to
    # indexing _GRAD3 but branch/gather-free (Perlin's bit trick).
    b = h & _U32(15)
    u = jnp.where(b < 8, dx, dy)
    v = jnp.where(b < 4, dy, jnp.where((b == 12) | (b == 14), dx, dz))
    su = jnp.where((b & _U32(1)) == 0, u, -u)
    sv = jnp.where((b & _U32(2)) == 0, v, -v)
    return su + sv


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(coords, seed):
    """Classic improved Perlin noise. coords: (..., 3) float. -> (...)."""
    coords = jnp.asarray(coords, jnp.float32)
    p0 = jnp.floor(coords)
    ip = p0.astype(jnp.int32)
    f = coords - p0
    ix, iy, iz = ip[..., 0], ip[..., 1], ip[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(ox, oy, oz):
        return _grad_dot(ix + ox, iy + oy, iz + oz,
                         fx - ox, fy - oy, fz - oz, seed)

    n000, n100 = g(0, 0, 0), g(1, 0, 0)
    n010, n110 = g(0, 1, 0), g(1, 1, 0)
    n001, n101 = g(0, 0, 1), g(1, 0, 1)
    n011, n111 = g(0, 1, 1), g(1, 1, 1)

    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return (nxy0 + w * (nxy1 - nxy0)) * jnp.float32(0.964921)  # ~unit range


_F3 = jnp.float32(1.0 / 3.0)
_G3 = jnp.float32(1.0 / 6.0)


def simplex3(coords, seed):
    """3D simplex noise (Gustavson's reference construction). (...,3)->(...)."""
    coords = jnp.asarray(coords, jnp.float32)
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    s = (x + y + z) * _F3
    i = jnp.floor(x + s)
    j = jnp.floor(y + s)
    k = jnp.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # Rank the components to find the simplex traversal order.
    gx = (x0 >= y0).astype(jnp.int32) + (x0 >= z0).astype(jnp.int32)
    gy = (y0 > x0).astype(jnp.int32) + (y0 >= z0).astype(jnp.int32)
    gz = (z0 > x0).astype(jnp.int32) + (z0 > y0).astype(jnp.int32)
    i1 = (gx >= 2).astype(jnp.int32)
    j1 = (gy >= 2).astype(jnp.int32)
    k1 = (gz >= 2).astype(jnp.int32)
    i2 = (gx >= 1).astype(jnp.int32)
    j2 = (gy >= 1).astype(jnp.int32)
    k2 = (gz >= 1).astype(jnp.int32)

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    ii = i.astype(jnp.int32)
    jj = j.astype(jnp.int32)
    kk = k.astype(jnp.int32)

    def corner(dx, dy, dz, oi, oj, ok):
        tt = 0.6 - dx * dx - dy * dy - dz * dz
        tt = jnp.maximum(tt, 0.0)
        g = _grad_dot(ii + oi, jj + oj, kk + ok, dx, dy, dz, seed)
        t2 = tt * tt
        return t2 * t2 * g

    n = (
        corner(x0, y0, z0, 0, 0, 0)
        + corner(x1, y1, z1, i1, j1, k1)
        + corner(x2, y2, z2, i2, j2, k2)
        + corner(x3, y3, z3, 1, 1, 1)
    )
    return 32.0 * n


def cellular3(coords, seed):
    """Worley / cellular-distance noise: distance to the nearest feature
    point, one feature point per unit cell (FastNoise CellularDistance
    analogue, TestMain.cpp:43,59-60). Output rescaled to roughly [-1, 1]."""
    coords = jnp.asarray(coords, jnp.float32)
    base = jnp.floor(coords).astype(jnp.int32)
    frac = coords - jnp.floor(coords)

    min_d2 = jnp.full(coords.shape[:-1], jnp.inf, jnp.float32)
    # 27-neighborhood, unrolled at trace time (static Python loop -> fully
    # vectorized XLA ops, no gather, no dynamic control flow).
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                cx = base[..., 0] + ox
                cy = base[..., 1] + oy
                cz = base[..., 2] + oz
                h = _hash3(cx, cy, cz, seed)
                # Three decorrelated uniforms from one hash.
                fxp = _hash_to_unit(h)
                fyp = _hash_to_unit(h * _U32(0x68E31DA4) ^ (h >> 13))
                fzp = _hash_to_unit(h * _U32(0xB5297A4D) ^ (h >> 7))
                dx = jnp.float32(ox) + fxp - frac[..., 0]
                dy = jnp.float32(oy) + fyp - frac[..., 1]
                dz = jnp.float32(oz) + fzp - frac[..., 2]
                d2 = dx * dx + dy * dy + dz * dz
                min_d2 = jnp.minimum(min_d2, d2)

    d = jnp.sqrt(min_d2)
    return d * jnp.float32(1.6) - jnp.float32(1.0)


def fbm3(coords, seed, octaves=5, lacunarity=2.0, gain=0.5):
    """Fractal Brownian motion over perlin3 — the cloud-density workhorse
    (BASELINE configs 2-5 use FBM cloud volumes)."""
    coords = jnp.asarray(coords, jnp.float32)
    total = jnp.zeros(coords.shape[:-1], jnp.float32)
    amp = jnp.float32(1.0)
    freq = jnp.float32(1.0)
    norm = jnp.float32(0.0)
    for o in range(octaves):
        total = total + amp * perlin3(coords * freq, seed + o * 1013)
        norm = norm + amp
        amp = amp * gain
        freq = freq * lacunarity
    return total / norm


_GENERATORS = {
    "perlin": perlin3,
    "simplex": simplex3,
    "cellular": cellular3,
}


def noise_grid(kind, size, frequency, seed, octaves=1):
    """Generate a size^3 grid of noise, mirroring FastNoise2's
    GenUniformGrid3D(start=0, size, frequency, seed) (TestMain.cpp:59-62):
    the sample at voxel (x,y,z) is noise((x,y,z) * frequency, seed).

    Returns float32 (size, size, size) indexed [z][y][x] like the reference's
    flat z-major layout (TestMain.cpp:69-90)."""
    idx = jnp.arange(size, dtype=jnp.float32) * jnp.float32(frequency)
    zz, yy, xx = jnp.meshgrid(idx, idx, idx, indexing="ij")
    coords = jnp.stack([xx, yy, zz], axis=-1)
    if kind == "fbm":
        return fbm3(coords, seed, octaves=octaves)
    gen = _GENERATORS[kind]
    return gen(coords, seed)
