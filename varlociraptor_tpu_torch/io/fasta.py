"""Indexed FASTA access with per-contig LRU buffering.

TPU-native replacement for the reference's ``reference::Buffer``
(``src/reference.rs:12-56``): lazy per-contig load into
immutable numpy uint8 arrays with LRU eviction (default capacity 10 contigs,
mirroring ``--reference-buffer-size``).  Sequences are uppercased at load time
(the reference realignment uppercases on the fly; we do it once since the
arrays feed device tensors).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np


class FastaBuffer:
    def __init__(self, path, capacity: int = 10, uppercase: bool = True):
        self.path = Path(path)
        self.capacity = capacity
        self.uppercase = uppercase
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._index = self._load_index()

    # ---- index -----------------------------------------------------------
    def _load_index(self):
        """Parse .fai if present; otherwise scan the FASTA once."""
        fai = Path(str(self.path) + ".fai")
        index = {}
        if fai.exists():
            for line in fai.read_text().splitlines():
                if not line.strip():
                    continue
                name, length, offset, linebases, linewidth = line.split("\t")[:5]
                index[name] = (
                    int(length),
                    int(offset),
                    int(linebases),
                    int(linewidth),
                )
        else:
            # full scan: record byte offsets of each contig
            with open(self.path, "rb") as f:
                name = None
                offset = None
                linebases = None
                linewidth = None
                length = 0
                pos = 0
                for raw in f:
                    line = raw.rstrip(b"\r\n")
                    if raw.startswith(b">"):
                        if name is not None:
                            index[name] = (length, offset, linebases, linewidth)
                        name = raw[1:].split()[0].decode()
                        offset = pos + len(raw)
                        length = 0
                        linebases = None
                        linewidth = None
                    elif line:
                        if linebases is None:
                            linebases = len(line)
                            linewidth = len(raw)
                        length += len(line)
                    pos += len(raw)
                if name is not None:
                    index[name] = (length, offset, linebases, linewidth)
        return index

    # ---- access ----------------------------------------------------------
    def contigs(self):
        return list(self._index.keys())

    def contig_length(self, name: str) -> int:
        return self._index[name][0]

    def seq(self, name: str) -> np.ndarray:
        """Whole contig as an immutable uint8 array (ASCII codes)."""
        if name in self._cache:
            self._cache.move_to_end(name)
            return self._cache[name]
        if name not in self._index:
            raise KeyError(f"contig {name!r} not in FASTA {self.path}")
        length, offset, linebases, linewidth = self._index[name]
        with open(self.path, "rb") as f:
            f.seek(offset)
            if linebases and linewidth and linewidth > linebases:
                nlines = (length + linebases - 1) // linebases
                nbytes = length + nlines * (linewidth - linebases)
            else:
                nbytes = length
            raw = f.read(nbytes)
        arr = np.frombuffer(raw, dtype=np.uint8)
        # strip newline bytes
        arr = arr[(arr != 10) & (arr != 13)][:length]
        if self.uppercase:
            lower = (arr >= 97) & (arr <= 122)
            arr = np.where(lower, arr - 32, arr)
        arr = np.ascontiguousarray(arr)
        arr.setflags(write=False)
        if len(self._cache) >= self.capacity:
            self._cache.popitem(last=False)
        self._cache[name] = arr
        return arr

    def fetch(self, name: str, start: int, end: int) -> np.ndarray:
        """Subsequence [start, end) clamped to the contig bounds."""
        s = self.seq(name)
        return s[max(0, start) : min(len(s), end)]


def seq_to_str(arr: np.ndarray) -> str:
    return arr.tobytes().decode("ascii")


def str_to_seq(s: str) -> np.ndarray:
    return np.frombuffer(s.upper().encode("ascii"), dtype=np.uint8)
