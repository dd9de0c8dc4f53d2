"""Bit-compatible reimplementation of the reference's scale-init RNG stream
(numpy only).

The port's own copy of ``gausplat_tpu/utils/rand_compat.py``, so that
``GaussianScene.from_points`` draws the same values without importing the
JAX package. The reference seeds ``StdRng::seed_from_u64(0x3D65)`` and
draws ``rand_distr::LogNormal::new(0.0f32, E)`` samples for the
``from_points`` scale initialisation (src/scene/gaussian_3d/import.rs:
217-237). Reproducing the *values* (not just the distribution) requires
the exact stream. This module reimplements, bit for bit:

- ``rand_core 0.6 SeedableRng::seed_from_u64``: a PCG32 sequence filling
  the 32-byte seed;
- ``rand_chacha 0.3 ChaCha12Rng`` (= ``rand::rngs::StdRng``): the ChaCha
  stream cipher with 12 rounds, 64-bit block counter and zero nonce,
  consumed as little-endian u64s (the ziggurat only draws u64-shaped
  values, so the block buffer never wraps mid-word);
- ``rand_distr 0.4 StandardNormal`` for f64: the 256-strip ziggurat with
  tables regenerated by the same recurrence rand's generator script uses
  (x[0] = v/f(r), x[1] = r, x[i] = f_inv(v/x[i-1] + f(x[i-1])), f64 math),
  including the ``Open01``-based tail ("zero case");
- ``rand_distr 0.4 LogNormal<f32>``: samples the f64 standard normal,
  casts to f32, scales by f32 E and exponentiates in f32.

Assumed crate versions: rand 0.8 / rand_core 0.6 / rand_chacha 0.3 /
rand_distr 0.4. Caveat: Rust's ``f32::exp`` is the platform libm, and
NumPy's may differ by 1 ulp on rare inputs; everything up to that final
exp is exact integer / IEEE-f64 arithmetic.
"""

from __future__ import annotations

import math

import numpy as np

# --- rand_core 0.6: seed_from_u64 (PCG32) --------------------------------------

_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723
_M64 = (1 << 64) - 1


def seed_from_u64(state: int) -> bytes:
    """32-byte ChaCha seed from a u64, as rand_core's default impl."""
    out = b""
    for _ in range(8):
        state = (state * _PCG_MUL + _PCG_INC) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) % 32))) & 0xFFFFFFFF
        out += x.to_bytes(4, "little")
    return out


# --- rand_chacha 0.3: ChaCha12 keystream ----------------------------------------


def _chacha12_blocks(key_words: np.ndarray, counters: np.ndarray) -> np.ndarray:
    """ChaCha12 keystream blocks for the given 64-bit block counters.

    ``key_words``: [8] uint32. ``counters``: [n] uint64 block indices.
    Returns [n, 16] uint32 output words (state + initial state after 12
    rounds; the reference layout: 4 constants, 8 key words, 2 counter
    words (lo, hi), 2 nonce words (zero for StdRng)).
    """
    n = counters.shape[0]
    state = np.empty((16, n), np.uint32)
    state[0] = 0x61707865
    state[1] = 0x3320646E
    state[2] = 0x79622D32
    state[3] = 0x6B206574
    for i in range(8):
        state[4 + i] = key_words[i]
    state[12] = (counters & 0xFFFFFFFF).astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[14] = 0
    state[15] = 0

    x = state.copy()

    def rotl(v, c):
        return (v << np.uint32(c)) | (v >> np.uint32(32 - c))

    def quarter(a, b, c, d):
        x[a] += x[b]
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = rotl(x[b] ^ x[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(6):  # 12 rounds = 6 double-rounds
            quarter(0, 4, 8, 12)
            quarter(1, 5, 9, 13)
            quarter(2, 6, 10, 14)
            quarter(3, 7, 11, 15)
            quarter(0, 5, 10, 15)
            quarter(1, 6, 11, 12)
            quarter(2, 7, 8, 13)
            quarter(3, 4, 9, 14)
        x += state
    return x.T  # [n, 16]


class ChaCha12U64Stream:
    """The StdRng keystream viewed as a sequence of little-endian u64s."""

    def __init__(self, seed: bytes, chunk_blocks: int = 1 << 14):
        assert len(seed) == 32
        self._key = np.frombuffer(seed, np.uint32)
        self._chunk_blocks = chunk_blocks
        self._next_block = 0
        self._buf = np.empty((0,), np.uint64)
        self._pos = 0

    def _refill(self):
        counters = np.arange(
            self._next_block, self._next_block + self._chunk_blocks, dtype=np.uint64
        )
        self._next_block += self._chunk_blocks
        words = _chacha12_blocks(self._key, counters).reshape(-1)
        u64 = words.reshape(-1, 2).astype(np.uint64)
        leftover = self._buf[self._pos:]
        self._buf = np.concatenate(
            [leftover, u64[:, 0] | (u64[:, 1] << np.uint64(32))]
        )
        self._pos = 0

    def take(self, n: int) -> np.ndarray:
        """Next n u64s (advances the stream)."""
        while self._buf.shape[0] - self._pos < n:
            self._refill()
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out


# --- rand_distr 0.4: ziggurat StandardNormal (f64) ------------------------------

ZIG_NORM_R = 3.654152885361008772953867343661


def _norm_f(x: float) -> float:
    return math.exp(-x * x / 2.0)


def _norm_f_inv(y: float) -> float:
    return math.sqrt(-2.0 * math.log(y))


def _norm_v() -> float:
    """Area of each ziggurat strip: r*f(r) + integral of f over the tail."""
    return ZIG_NORM_R * _norm_f(ZIG_NORM_R) + math.sqrt(
        math.pi / 2.0
    ) * math.erfc(ZIG_NORM_R / math.sqrt(2.0))


def _make_tables():
    n = 256
    v = _norm_v()
    x = [0.0] * (n + 1)
    x[0] = v / _norm_f(ZIG_NORM_R)
    x[1] = ZIG_NORM_R
    for i in range(2, n):
        x[i] = _norm_f_inv(v / x[i - 1] + _norm_f(x[i - 1]))
    x[n] = 0.0
    f = [_norm_f(xx) for xx in x]
    return np.asarray(x, np.float64), np.asarray(f, np.float64)


ZIG_NORM_X, ZIG_NORM_F = _make_tables()

_U64_TO_OPEN01_BIAS = 1.0 - np.finfo(np.float64).eps / 2.0


def _into_float_with_exponent(bits: int, exponent: int) -> float:
    """rand's u64 -> f64 helper: top 52 bits as mantissa, given exponent.
    (1 + frac/2^52) * 2^exponent — exact in f64."""
    return math.ldexp(float((bits >> 12) | (1 << 52)), exponent - 52)


def _open01(bits: int) -> float:
    # bits.into_float_with_exponent(0) - (1 - eps/2): a value in (0, 1].
    return _into_float_with_exponent(bits, 0) - _U64_TO_OPEN01_BIAS


def standard_normal_f64(stream: ChaCha12U64Stream, count: int) -> np.ndarray:
    """``count`` f64 standard-normal samples, consuming the stream exactly
    as rand_distr's ziggurat does (vectorized fast path: the ~98.9% of
    samples whose first u64 is accepted outright; scalar resolution for
    the rest, preserving stream order)."""
    out = np.empty(count, np.float64)
    done = 0
    while done < count:
        # Chunked: rejections occur every ~90 samples, so re-taking the
        # full remainder per rejection would be quadratic.
        want = min(count - done, 4096)
        bits = stream.take(want)
        idx = (bits & np.uint64(0xFF)).astype(np.int64)
        # into_float_with_exponent(1) - 3.0: exponent field = 1023 + 1.
        u = ((bits >> np.uint64(12)) | np.uint64(1024 << 52)).view(
            np.float64
        ) - 3.0
        x = u * ZIG_NORM_X[idx]
        accept = np.abs(x) < ZIG_NORM_X[idx + 1]
        # Vectorized prefix: samples up to the first rejection are final.
        first_bad = int(np.argmin(accept)) if not accept.all() else want
        out[done : done + first_bad] = x[:first_bad]
        done += first_bad
        if first_bad == want:
            break
        # Scalar-resolve the rejected sample; unconsumed u64s after it in
        # `bits` are NOT part of the stream (we re-take them next round),
        # so rewind the stream to just after the rejected draw.
        stream._pos -= want - first_bad - 1
        b = int(bits[first_bad])
        out[done] = _zig_resolve(stream, b)
        done += 1
    return out


def _zig_resolve(stream: ChaCha12U64Stream, bits: int) -> float:
    """Finish one ziggurat sample whose first draw `bits` was not accepted
    by the fast strip test."""
    while True:
        i = bits & 0xFF
        u = _into_float_with_exponent(bits, 1) - 3.0
        x = u * ZIG_NORM_X[i]
        if abs(x) < ZIG_NORM_X[i + 1]:
            return x
        if i == 0:
            # Tail: Marsaglia's method with Open01 draws.
            xx, yy = 1.0, 0.0
            while -2.0 * yy < xx * xx:
                x_ = _open01(int(stream.take(1)[0]))
                y_ = _open01(int(stream.take(1)[0]))
                xx = math.log(x_) / ZIG_NORM_R
                yy = math.log(y_)
            return xx - ZIG_NORM_R if u < 0.0 else ZIG_NORM_R - xx
        # Wedge test: f_tab[i+1] + (f_tab[i] - f_tab[i+1]) * U < pdf(x).
        w = int(stream.take(1)[0])
        uu = (w >> 11) * (1.0 / (1 << 53))
        if ZIG_NORM_F[i + 1] + (ZIG_NORM_F[i] - ZIG_NORM_F[i + 1]) * uu < _norm_f(x):
            return x
        bits = int(stream.take(1)[0])


def reference_lognormal_e_f32(count: int, seed: int = 0x3D65) -> np.ndarray:
    """``count`` samples of the reference's LogNormal(0, e) f32 stream:
    StdRng(seed) -> f64 standard normal -> f32 cast -> * E (f32) -> exp."""
    stream = ChaCha12U64Stream(seed_from_u64(seed))
    z = standard_normal_f64(stream, count).astype(np.float32)
    e32 = np.float32(math.e)
    return np.exp(e32 * z, dtype=np.float32)
