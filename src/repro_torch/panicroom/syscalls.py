"""PanicRoom BSP: 4 non-portable syscalls + a portable layer above them.

Paper contract (Table II / Fig. 10): platform support needs exactly
``init, exit, sendchar, getchar``; everything else (open/read/write/seek,
printf) is platform-independent, built on the BlockFS. Programs cannot tell
whether they run under simulation (the kernels' plain PyTorch versions on
host tensors) or hardware (the hand-written kernels on the card): the
runner swaps the backend, not the benchmark. A copy of the JAX package's
``panicroom/syscalls.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.panicroom.fs import BlockFS

SYSCALL_NAMES = ("init", "exit", "sendchar", "getchar")


class BSP:
    """Board support package. The four primitives are injectable: the
    ZynqParrot analogue of swapping the VPS transport layer."""

    def __init__(self, fs: Optional[BlockFS] = None,
                 stdin: bytes = b"",
                 sendchar: Optional[Callable[[int], None]] = None):
        self.fs = fs or BlockFS()
        self._stdin = list(stdin)
        self._stdout: List[int] = []
        self._sendchar_hook = sendchar
        self.exited: Optional[int] = None
        self.counts: Dict[str, int] = {n: 0 for n in SYSCALL_NAMES}
        self.counts.update(open=0, read=0, write=0, close=0)

    # ---- the 4 non-portable primitives ------------------------------------
    def init(self):
        self.counts["init"] += 1

    def exit(self, code: int = 0):
        self.counts["exit"] += 1
        self.exited = code

    def sendchar(self, c: int):
        self.counts["sendchar"] += 1
        self._stdout.append(c & 0xFF)
        if self._sendchar_hook:
            self._sendchar_hook(c)

    def getchar(self) -> int:
        self.counts["getchar"] += 1
        return self._stdin.pop(0) if self._stdin else -1

    # ---- portable layer (libgloss analogue) -------------------------------
    def open(self, name: str, mode: str = "r") -> int:
        self.counts["open"] += 1
        return self.fs.open(name, mode)

    def read(self, fd: int, n: int = -1) -> bytes:
        self.counts["read"] += 1
        return self.fs.read(fd, n)

    def write(self, fd: int, data: bytes) -> int:
        self.counts["write"] += 1
        if fd == 1:                       # stdout via sendchar
            for c in data:
                self.sendchar(c)
            return len(data)
        return self.fs.write(fd, data)

    def close(self, fd: int):
        self.counts["close"] += 1
        self.fs.close(fd)

    def puts(self, s: str):
        self.write(1, s.encode() + b"\n")

    @property
    def stdout(self) -> bytes:
        return bytes(self._stdout)
