"""PanicRoom filesystem: a deterministic in-memory block FS.

The paper backs libgloss with ARM LittleFS over DRAM; the analogue here is
a block-allocated FS over one contiguous buffer, so POSIX-style file I/O is
a *synchronous function of memory*: deterministic and identical across
simulation and hardware, with no host tether. A copy of the JAX package's
``panicroom/fs.py``; the same operations leave byte-identical ``mem``,
``files`` and ``sizes`` in both.
"""
from __future__ import annotations

from typing import Dict, List

BLOCK = 512


class BlockFS:
    def __init__(self, size_bytes: int = 1 << 20):
        self.nblocks = size_bytes // BLOCK
        self.mem = bytearray(self.nblocks * BLOCK)
        self.free = list(range(self.nblocks - 1, -1, -1))
        self.files: Dict[str, List[int]] = {}   # name -> block list
        self.sizes: Dict[str, int] = {}
        self.fds: Dict[int, dict] = {}
        self._next_fd = 3                       # 0,1,2 reserved

    # ------------------------------------------------------------ layout ---
    def _alloc(self) -> int:
        if not self.free:
            raise OSError(28, "ENOSPC")
        return self.free.pop()

    def exists(self, name: str) -> bool:
        return name in self.files

    def listdir(self) -> List[str]:
        return sorted(self.files)

    def unlink(self, name: str):
        for b in self.files.pop(name, []):
            self.free.append(b)
        self.sizes.pop(name, None)

    # ------------------------------------------------------------- posix ---
    def open(self, name: str, mode: str = "r") -> int:
        if "w" in mode:
            if name in self.files:
                self.unlink(name)
            self.files[name] = []
            self.sizes[name] = 0
        elif name not in self.files:
            raise FileNotFoundError(name)
        fd = self._next_fd
        self._next_fd += 1
        self.fds[fd] = {"name": name, "pos": 0, "mode": mode}
        return fd

    def close(self, fd: int):
        self.fds.pop(fd)

    def write(self, fd: int, data: bytes) -> int:
        st = self.fds[fd]
        name = st["name"]
        end = st["pos"] + len(data)
        blocks = self.files[name]
        while len(blocks) * BLOCK < end:
            blocks.append(self._alloc())
        off = 0
        pos = st["pos"]
        while off < len(data):
            b = blocks[pos // BLOCK]
            k = pos % BLOCK
            n = min(BLOCK - k, len(data) - off)
            self.mem[b * BLOCK + k: b * BLOCK + k + n] = data[off:off + n]
            off += n
            pos += n
        st["pos"] = pos
        self.sizes[name] = max(self.sizes[name], pos)
        return len(data)

    def read(self, fd: int, n: int = -1) -> bytes:
        st = self.fds[fd]
        name = st["name"]
        size = self.sizes[name]
        if n < 0:
            n = size - st["pos"]
        n = max(0, min(n, size - st["pos"]))
        out = bytearray()
        pos = st["pos"]
        blocks = self.files[name]
        while len(out) < n:
            b = blocks[pos // BLOCK]
            k = pos % BLOCK
            m = min(BLOCK - k, n - len(out))
            out += self.mem[b * BLOCK + k: b * BLOCK + k + m]
            pos += m
        st["pos"] = pos
        return bytes(out)

    def seek(self, fd: int, pos: int):
        self.fds[fd]["pos"] = pos
