"""The port's PanicRoom (``repro_torch.panicroom``): the five cases of the
JAX package's ``tests/test_panicroom.py`` on the port's package, the same
operations on the port's and the reference's ``BlockFS`` leaving
byte-identical memory, files and sizes, and the grouped-GEMM program of
``benchmarks/bench_panicroom.py`` written again for the port ("sim": K5's
plain version on host tensors; "hw" needs the card and raises without
one)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.panicroom import BlockFS as JaxBlockFS  # noqa: E402
from repro.panicroom import BSP as JaxBSP  # noqa: E402
from repro.panicroom import run_benchmark as jax_run  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gg_ops  # noqa: E402
from repro_torch.panicroom import BSP, BlockFS, run_benchmark  # noqa: E402
from repro_torch.panicroom import SYSCALL_NAMES  # noqa: E402
from repro_torch.panicroom.fs import BLOCK  # noqa: E402
from repro_torch.panicroom.programs import (bsp_loc, fs_bytes,  # noqa: E402
                                            grouped_gemm_program)


# ------------------------------------------ the reference's five cases ---
def test_fs_basic_roundtrip():
    fs = BlockFS(1 << 16)
    fd = fs.open("a", "w")
    fs.write(fd, b"hello world")
    fs.close(fd)
    fd = fs.open("a")
    assert fs.read(fd) == b"hello world"
    fs.close(fd)
    assert fs.listdir() == ["a"]
    fs.unlink("a")
    assert not fs.exists("a")


@settings(max_examples=25, deadline=None)
@given(chunks=st.lists(st.binary(min_size=0, max_size=3 * BLOCK),
                       min_size=1, max_size=6))
def test_fs_chunked_write_read_property(chunks):
    """Any sequence of writes reads back as the concatenation, across
    block boundaries."""
    fs = BlockFS(1 << 18)
    fd = fs.open("f", "w")
    for c in chunks:
        fs.write(fd, c)
    fs.close(fd)
    fd = fs.open("f")
    assert fs.read(fd) == b"".join(chunks)


def test_fs_enospc():
    fs = BlockFS(BLOCK * 4)
    fd = fs.open("big", "w")
    with pytest.raises(OSError):
        fs.write(fd, b"x" * (BLOCK * 10))


def test_bsp_four_syscalls_and_stdout():
    bsp = BSP(stdin=b"hi")
    bsp.init()
    assert bsp.getchar() == ord("h")
    bsp.puts("ok")
    bsp.exit(0)
    assert bsp.stdout == b"ok\n"
    for name in SYSCALL_NAMES:
        assert bsp.counts[name] > 0


def test_runner_sim_hw_identical():
    def bench(bsp, platform):
        fd = bsp.open("x", "w")
        bsp.write(fd, b"\x01\x02\x03")
        bsp.close(fd)
        fd = bsp.open("x")
        data = bsp.read(fd)
        bsp.puts(str(sum(data)))
        return {"sum": sum(data)}

    sim = run_benchmark(bench, "sim")
    hw = run_benchmark(bench, "hw")
    assert sim["stdout"] == hw["stdout"]        # programs cannot tell
    assert sim["result"] == hw["result"]
    assert sim["syscalls"] == hw["syscalls"]
    # and the reference's runner gives the same report
    ref = jax_run(bench, "sim")
    assert {k: ref[k] for k in ("stdout", "syscalls", "result")} == \
        {k: sim[k] for k in ("stdout", "syscalls", "result")}


# ------------------------------------------------- against the reference ---
NAMES = ("a", "b", "c")


def _apply(fs, ops, chunks):
    """Op codes over three files: 0 write anew, 1 overwrite from a seek,
    2 read back, 3 unlink, 4 write at the end of what is there."""
    reads = []
    for i, (op, data) in enumerate(zip(ops, chunks)):
        name = NAMES[i % len(NAMES)]
        if op == 0 or (op in (1, 2, 4) and not fs.exists(name)):
            fd = fs.open(name, "w")
            fs.write(fd, data)
        elif op == 1:
            fd = fs.open(name, "r")
            fs.seek(fd, len(data) % (fs.sizes[name] + 1))
            fs.write(fd, data)
        elif op == 2:
            fd = fs.open(name, "r")
            reads.append(fs.read(fd, len(data) or -1))
        elif op == 4:
            fd = fs.open(name, "r")
            fs.seek(fd, fs.sizes[name])
            fs.write(fd, data)
        else:
            fs.unlink(name)
            continue
        fs.close(fd)
    return reads


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.integers(0, 4), min_size=1, max_size=12),
       chunks=st.lists(st.binary(min_size=0, max_size=3 * BLOCK),
                       min_size=12, max_size=12))
def test_fs_is_byte_identical_to_the_reference(ops, chunks):
    """The same operations on the port's and the reference's BlockFS leave
    byte-identical memory, files, sizes and free lists, and read the same
    bytes."""
    port, ref = BlockFS(1 << 15), JaxBlockFS(1 << 15)
    assert _apply(port, ops, chunks) == _apply(ref, ops, chunks)
    assert port.mem == ref.mem
    assert port.files == ref.files and port.sizes == ref.sizes
    assert port.free == ref.free


def test_bsp_counts_like_the_reference():
    port, ref = BSP(stdin=b"xyz"), JaxBSP(stdin=b"xyz")
    for bsp in (port, ref):
        bsp.init()
        bsp.getchar()
        fd = bsp.open("f", "w")
        bsp.write(fd, b"abc" * 300)
        bsp.close(fd)
        bsp.puts("done")
        bsp.exit(3)
    assert port.counts == ref.counts and port.stdout == ref.stdout
    assert port.exited == ref.exited == 3


# ----------------------------------------------------- the K5 program ---
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_program_under_sim(dtype):
    """The program's product read back from the FS equals the plain
    per-expert product of its operands; no kernel launches on the host;
    its checksum is printed."""
    x_shape, w_shape = (3, 8, 32), (3, 32, 24)
    bsp = BSP(fs=BlockFS(fs_bytes(x_shape, w_shape, dtype)))
    before = gg_ops.grouped_gemm.launches
    r = run_benchmark(grouped_gemm_program(x_shape, w_shape, dtype, seed=0),
                      "sim", bsp=bsp)
    assert gg_ops.grouped_gemm.launches == before
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(x_shape, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(w_shape, dtype=np.float32))
    want = torch.einsum("emk,ekn->emn", x.to(dtype).float(),
                        w.to(dtype).float()).to(dtype)
    assert torch.equal(r["result"]["out"], want)
    assert r["stdout"] == f"checksum={float(want.float().sum()):.3f}\n"
    assert r["exit_code"] == 0 and r["syscalls"]["open"] == 6
    assert sorted(bsp.fs.listdir()) == ["out.bin", "w.bin", "x.bin"]


def test_default_program_is_the_reference_benchmark():
    """With no w, the program is the reference benchmark's a @ a on a
    (2, 32, 32) draw from seed 0."""
    r = run_benchmark(grouped_gemm_program(), "sim")
    a = np.random.default_rng(0).standard_normal((2, 32, 32),
                                                 dtype=np.float32)
    want = np.einsum("emk,ekn->emn", a, a)
    np.testing.assert_allclose(r["result"]["out"].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert r["stdout"].split("=")[0] == "checksum"


def test_hw_without_a_card_raises():
    """'hw' runs the kernel on the card; where there is none it raises
    rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card test runs 'hw'")
    with pytest.raises((RuntimeError, AssertionError)):
        run_benchmark(grouped_gemm_program(), "hw")


def test_bsp_loc_counts_the_four_modules():
    assert 100 < bsp_loc() < 300
    with pytest.raises(ValueError, match="platform"):
        run_benchmark(lambda bsp, p: {}, "fpga")
