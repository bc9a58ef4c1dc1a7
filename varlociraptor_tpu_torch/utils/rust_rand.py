"""Bit-exact reimplementation of the rust `rand` crate pieces the reference
uses for depth subsampling (sample.rs:180-212):

    StdRng::seed_from_u64(48074578)  +  Uniform::new(0.0, 1.0)

- ``seed_from_u64`` expands a u64 to a 32-byte seed with PCG32
  (rand_core::SeedableRng default impl).
- ``StdRng`` is ChaCha12: 64-byte blocks, 12 rounds, little-endian u32
  word stream; ``next_u64`` consumes two consecutive u32 (lo, hi).
- ``Uniform<f64>`` samples ``value1_2 = from_bits(0x3FF<<52 | (u64>>11)
  & mantissa) in [1,2)`` then returns ``value1_2 * scale + offset`` with
  ``scale = high - low``, ``offset = low - scale``.

Matching this exactly makes our per-locus subsampling decisions identical
to the reference's, which matters for testcase parity at high-depth loci.
"""

from __future__ import annotations

import struct

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _pcg32_seed_expand(state: int, n_bytes: int = 32) -> bytes:
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    while len(out) < n_bytes:
        state = (state * MUL + INC) & MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32
        out.extend(struct.pack("<I", x))
    return bytes(out[:n_bytes])


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & MASK32
    s[a] = (s[a] + s[b]) & MASK32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & MASK32


class ChaCha12:
    """ChaCha with 12 rounds, 64-bit block counter at words 12-13 and
    64-bit stream id at words 14-15 (rand_chacha layout)."""

    CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

    def __init__(self, seed32: bytes):
        assert len(seed32) == 32
        self.key = struct.unpack("<8I", seed32)
        self.counter = 0
        self._buf: list[int] = []

    def _block(self, counter: int) -> list[int]:
        init = list(self.CONSTANTS) + list(self.key) + [
            counter & MASK32,
            (counter >> 32) & MASK32,
            0,
            0,
        ]
        s = init[:]
        for _ in range(6):  # 12 rounds = 6 double rounds
            _quarter_round(s, 0, 4, 8, 12)
            _quarter_round(s, 1, 5, 9, 13)
            _quarter_round(s, 2, 6, 10, 14)
            _quarter_round(s, 3, 7, 11, 15)
            _quarter_round(s, 0, 5, 10, 15)
            _quarter_round(s, 1, 6, 11, 12)
            _quarter_round(s, 2, 7, 8, 13)
            _quarter_round(s, 3, 4, 9, 14)
        return [(x + y) & MASK32 for x, y in zip(s, init)]

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = self._block(self.counter)
            self.counter += 1
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


class StdRng(ChaCha12):
    @classmethod
    def seed_from_u64(cls, seed: int) -> "StdRng":
        return cls(_pcg32_seed_expand(seed & MASK64))

    def gen_uniform_01(self) -> float:
        """Uniform::new(0.0, 1.0).sample(rng) — rand 0.8 semantics."""
        value = self.next_u64()
        fraction = (value >> 11) & ((1 << 52) - 1)
        (value1_2,) = struct.unpack(
            "<d", struct.pack("<Q", (0x3FF << 52) | fraction)
        )
        return value1_2 - 1.0


class SubsampleCandidates:
    """sample.rs:180-212 parity: per-locus decision sequence."""

    SEED = 48074578

    def __init__(self, max_depth: int, depth: int):
        self.necessary = depth > max_depth
        if self.necessary:
            self.rng = StdRng.seed_from_u64(self.SEED)
            self.prob = max_depth / depth

    def keep(self) -> bool:
        if not self.necessary:
            return True
        return self.rng.gen_uniform_01() <= self.prob
