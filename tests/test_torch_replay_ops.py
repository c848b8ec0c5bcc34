"""The port's replay-ring ops against the JAX package's: ``ring_write`` /
``ring_gather`` in Pallas interpret mode and their jnp ``*_ref`` oracles.
Both sides only copy rows, so every comparison is bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t

from repro.kernels import replay_ops as jops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_counts():
    rops.reset_launch_counts()
    yield
    # the CPU path never reaches a kernel
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def _jax_write(data, batch, ptr, **kw):
    """(interpret-mode Pallas kernel, jnp oracle) on the same inputs."""
    d, b = jnp.asarray(data), jnp.asarray(batch)
    p = jnp.asarray(ptr, jnp.int32)
    return (np.asarray(jops.ring_write(d, b, p, interpret=True, **kw)),
            np.asarray(jops.ring_write_ref(d, b, p, **kw)))


@pytest.mark.parametrize("cap,nrows,ptr,row", [
    (16, 5, 3, (3,)),     # plain append
    (13, 8, 9, (3,)),     # wraps at the ring end mid-batch
    (13, 13, 12, ()),     # full-capacity write, wraps, scalar rows
    (40, 32, 30, (1,)),   # one round of the small trainer, wrapping
])
def test_ring_write_matches_jax(cap, nrows, ptr, row):
    rng = np.random.default_rng(cap * 100 + ptr)
    data = rng.standard_normal((cap,) + row).astype(np.float32)
    batch = rng.standard_normal((nrows,) + row).astype(np.float32)
    want_kernel, want_ref = _jax_write(data, batch, ptr)
    got = n(kops.ring_write(t(data), t(batch), t(np.int32(ptr))))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


@pytest.mark.parametrize("lo", [0, 8, 16, 24])
def test_ring_write_partial_window(lo):
    """A 32-slot ring split into windows of 8: each keeps exactly the
    rows of a wrapping write that land in its slots."""
    rng = np.random.default_rng(lo)
    cap, nrows, ptr = 32, 12, 28
    data = rng.standard_normal((8, 3)).astype(np.float32)
    batch = rng.standard_normal((nrows, 3)).astype(np.float32)
    want_kernel, want_ref = _jax_write(data, batch, ptr, capacity=cap,
                                       window_start=lo)
    got = n(kops.ring_write(t(data), t(batch), t(np.int32(ptr)),
                            capacity=cap, window_start=lo))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


def test_ring_write_over_capacity_raises():
    data, batch = torch.zeros(4, 2), torch.zeros(5, 2)
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        kops.ring_write(data, batch, ptr)
    with pytest.raises(ValueError, match="capacity"):
        jops.ring_write(jnp.zeros((4, 2)), jnp.zeros((5, 2)), 0,
                        interpret=True)


def test_ring_write_dtype_mismatch_raises():
    with pytest.raises(TypeError):
        kops.ring_write(torch.zeros(4, 2), torch.zeros(2, 2,
                                                       dtype=torch.float64),
                        torch.zeros((), dtype=torch.int32))


# Pendulum's six replay fields (widths 3, 1, 1, 3, 1, 1) and a field of
# (2, 3) rows: the trainer's round, one field more
FIELD_ROWS = [(3,), (1,), (), (3,), (), (), (2, 3)]


def _fields(rng, rows, nrows):
    datas = [rng.standard_normal((rows,) + r).astype(np.float32)
             for r in FIELD_ROWS]
    batches = [rng.standard_normal((nrows,) + r).astype(np.float32)
               for r in FIELD_ROWS]
    return datas, batches


# (capacity, rows of the pool, n, ptr, window_start)
FIELD_CASES = {
    "mid_ring": (40, 40, 12, 5, None),
    "wraps": (13, 13, 8, 9, None),           # wraps mid-batch
    "n_is_capacity": (13, 13, 13, 12, None),
    # slots 22..31 and (wrapped) 0, 1: a window of slots 24..31 keeps 8
    "window": (32, 8, 12, 22, 24),
}


@pytest.mark.parametrize("case", FIELD_CASES)
def test_ring_write_fields_matches_jax(case):
    """Every field of one write, uneven widths, against the JAX kernel
    (interpret mode) and its oracle, and against ``ring_write_ref`` field
    by field."""
    cap, rows, nrows, ptr, lo = FIELD_CASES[case]
    rng = np.random.default_rng(nrows * 100 + ptr)
    datas, batches = _fields(rng, rows, nrows)
    kw = {} if lo is None else {"capacity": cap, "window_start": lo}
    got = kops.ring_write_fields([t(d) for d in datas],
                                 [t(b) for b in batches],
                                 t(np.int32(ptr)), **kw)
    assert len(got) == len(FIELD_ROWS)
    assert not np.array_equal(n(got[0]), datas[0])    # rows were written
    for d, b, g in zip(datas, batches, got):
        want_kernel, want_ref = _jax_write(d, b, ptr, **kw)
        np.testing.assert_array_equal(n(g), want_kernel)
        np.testing.assert_array_equal(n(g), want_ref)
        np.testing.assert_array_equal(n(g), n(rops.ring_write_ref(
            t(d), t(b), t(np.int32(ptr)), **kw)))


def emulate_ring_write_kernel(datas, batches, ptr, cap, lo=0,
                              floor_mod=False, widths=None, threads=256):
    """numpy model of ``ring_write_kernel`` in ``csrc/ring_ops.cu`` over
    the whole grid: (ceil(n * widest / threads), fields) blocks of
    ``threads``; thread x of block (bx, by) takes element e = bx *
    threads + x of field by, row i = e // width and feature e - i *
    width, and writes it to slot (ptr + i) % cap (C's remainder, the
    sign of the dividend) less ``lo``, or, with ``floor_mod`` (the
    row-at-a-time baseline: no window), to the remainder taken as a
    floor; only slots inside the pool are written. ``widths`` overrides
    the row widths, to model a faulty kernel."""
    rows_local, nrows = datas[0].shape[0], batches[0].shape[0]
    widths = widths or [d.size // rows_local for d in datas]
    blocks = -(-nrows * max(widths) // threads)
    out = [d.copy() for d in datas]
    for by, width in enumerate(widths):
        dst, src = out[by].reshape(-1), batches[by].reshape(-1)
        e = np.arange(blocks * threads)
        e = e[e < nrows * width]
        i = e // width
        f = e - i * width
        dest = np.fmod(np.int64(ptr) + i, cap)
        dest = np.where(dest < 0, dest + cap, dest) if floor_mod else \
            dest - lo
        inside = (dest >= 0) & (dest < rows_local)
        dst[dest[inside] * width + f[inside]] = src[e[inside]]
    return out


@pytest.mark.parametrize("case", FIELD_CASES)
def test_ring_write_kernel_index_math(case):
    """The kernel's grid and index rule, emulated in numpy, give what the
    plain versions give, for every field."""
    cap, rows, nrows, ptr, lo = FIELD_CASES[case]
    rng = np.random.default_rng(nrows + ptr)
    datas, batches = _fields(rng, rows, nrows)
    got = emulate_ring_write_kernel(datas, batches, ptr, cap, lo or 0)
    kw = {} if lo is None else {"capacity": cap, "window_start": lo}
    want = rops.ring_write_fields_ref([t(d) for d in datas],
                                      [t(b) for b in batches],
                                      t(np.int32(ptr)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, n(w))


@pytest.mark.parametrize("mutation", ["field_width", "row_offset",
                                      "no_window"])
def test_ring_write_kernel_emulation_catches_a_fault(mutation):
    """The emulation above is strict enough to catch a faulty kernel: a
    field width off by one, a slot off by one, a window not applied."""
    cap, rows, nrows, ptr, lo = FIELD_CASES["window"]
    rng = np.random.default_rng(7)
    datas, batches = _fields(rng, rows, nrows)
    want = rops.ring_write_fields_ref([t(d) for d in datas],
                                      [t(b) for b in batches],
                                      t(np.int32(ptr)), capacity=cap,
                                      window_start=lo)
    widths = [d.size // rows for d in datas]
    if mutation == "field_width":
        widths[0] -= 1
    got = emulate_ring_write_kernel(
        datas, batches, ptr + (mutation == "row_offset"), cap,
        0 if mutation == "no_window" else lo, widths=widths)
    assert not all(np.array_equal(g, n(w)) for g, w in zip(got, want))


def test_ring_write_fields_count_mismatch_raises():
    with pytest.raises(ValueError, match="2 batches into 1 fields"):
        kops.ring_write_fields([torch.zeros(4, 2)],
                               [torch.zeros(2, 2), torch.zeros(2, 2)],
                               torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("pool,rows", [((8, 2, 3), (3, 6)),
                                       ((8, 3, 1), (3, 3)),
                                       ((8, 2, 3), (3, 3, 2))])
def test_ring_write_row_shape_mismatch_raises(pool, rows):
    """A batch whose rows hold as many elements as the pool's but in
    another shape is refused by the plain versions, as the kernel's
    binding refuses it."""
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        kops.ring_write(torch.zeros(pool), torch.ones(rows), ptr)
    with pytest.raises(ValueError, match="do not match"):
        kops.ring_write_fields([torch.zeros(8), torch.zeros(pool)],
                               [torch.ones(3), torch.ones(rows)], ptr)


@pytest.mark.parametrize("lo,rows", [(0, 37), (10, 16)])
@pytest.mark.parametrize("row", [(), (3,)])
def test_ring_gather_matches_jax(lo, rows, row):
    """In-window, out-of-window and -1 padding indices; out-of-window
    rows come back as zeros."""
    rng = np.random.default_rng(rows + lo)
    data = rng.standard_normal((rows,) + row).astype(np.float32)
    idx = np.concatenate([
        rng.integers(lo, lo + rows, 50),          # inside the window
        rng.integers(0, lo + 2 * rows, 20),       # some outside it
        [-1, -1, lo - 1, lo + rows]]).astype(np.int32)
    want_kernel = np.asarray(jops.ring_gather(
        jnp.asarray(data), jnp.asarray(idx), window_start=lo,
        interpret=True))
    want_ref = np.asarray(jops.ring_gather_ref(
        jnp.asarray(data), jnp.asarray(idx), window_start=lo))
    got = n(kops.ring_gather(t(data), t(idx), window_start=lo))
    assert got.shape == (len(idx),) + row
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)
    assert not got[-4:].any()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch CUDA kernels only: a CPU operand is
    refused before anything is built or launched."""
    data = torch.zeros(8, 3)
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_write(data, torch.zeros(2, 3), ptr)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_gather(data, torch.zeros(4, dtype=torch.int32))


def test_ring_write_fields_refuses_cpu_tensors():
    """The one-launch write refuses a pool off the card before anything
    is built, as the one-field wrapper does."""
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_write_fields([torch.zeros(8, 3), torch.zeros(8)],
                               [torch.zeros(2, 3), torch.zeros(2)],
                               torch.zeros((), dtype=torch.int32))


# Pendulum's six replay fields as the trainer keeps them (obs (3,), act
# (1,), rew, done and disc 1-d), a seventh 1-d field (the PER priority
# mass) and a field of (2, 3) rows
GATHER_ROWS = [(3,), (1,), (), (3,), (), (), (), (2, 3)]

# (rows of the pool, window_start)
GATHER_CASES = {"mid_pool": (37, None), "window": (16, 10)}


def _gather_inputs(rng, rows, lo):
    """Pools of GATHER_ROWS and indices: inside the window, some outside
    it, -1 padding and the window's two neighbours."""
    base = lo or 0
    datas = [rng.standard_normal((rows,) + r).astype(np.float32)
             for r in GATHER_ROWS]
    idx = np.concatenate([
        rng.integers(base, base + rows, 50),       # inside the window
        rng.integers(0, base + 2 * rows, 20),      # some outside it
        [-1, -1, base - 1, base + rows]]).astype(np.int32)
    return datas, idx


@pytest.mark.parametrize("case", GATHER_CASES)
def test_ring_gather_fields_matches_jax(case):
    """Every field of one gather, uneven row shapes, bit for bit against
    the JAX kernel (interpret mode) and its oracle, and against the
    port's ``ring_gather_ref`` field by field."""
    rows, lo = GATHER_CASES[case]
    rng = np.random.default_rng(rows + (lo or 0))
    datas, idx = _gather_inputs(rng, rows, lo)
    kw = {} if lo is None else {"window_start": lo}
    got = kops.ring_gather_fields([t(d) for d in datas], t(idx), **kw)
    assert len(got) == len(GATHER_ROWS)
    for d, g in zip(datas, got):
        g = n(g)
        assert g.shape == (len(idx),) + d.shape[1:]
        want_kernel = np.asarray(jops.ring_gather(
            jnp.asarray(d), jnp.asarray(idx), window_start=lo or 0,
            interpret=True))
        want_ref = np.asarray(jops.ring_gather_ref(
            jnp.asarray(d), jnp.asarray(idx), window_start=lo or 0))
        np.testing.assert_array_equal(g, want_kernel)
        np.testing.assert_array_equal(g, want_ref)
        np.testing.assert_array_equal(g, n(rops.ring_gather_ref(
            t(d), t(idx), **kw)))
        assert g[:50].any() and not g[-4:].any()


def emulate_ring_gather_kernel(datas, idx, lo=0, clamp=False, widths=None,
                               threads=128, rows_per_block=128):
    """numpy model of ``ring_gather_kernel`` in ``csrc/ring_ops.cu`` over
    the whole grid: (ceil(bsz / rows_per_block), fields) blocks of
    ``threads``. Block (bx, by) takes output rows row0 = bx *
    rows_per_block onwards: each row's source is idx - ``lo``, or -1 (a
    row of zeros) outside the pool; with ``clamp`` (the row-at-a-time
    baseline's rule: no window) a negative index is taken from the end
    once and the rest clamped into the pool. Thread x then takes the
    block's elements e = x, x + threads, ...: row r = e // width, feature
    e - r * width, stored at row0 * width + e. ``widths`` overrides the
    row widths, to model a faulty kernel."""
    rows_local, bsz = datas[0].shape[0], idx.shape[0]
    widths = widths or [d.size // rows_local for d in datas]
    outs = []
    for data, width in zip(datas, widths):
        src_flat = data.reshape(-1)
        dst = np.zeros(bsz * (data.size // rows_local), np.float32)
        for row0 in range(0, bsz, rows_per_block):
            rows = min(rows_per_block, bsz - row0)
            j = idx[row0:row0 + rows].astype(np.int64)
            if clamp:
                j = np.clip(np.where(j < 0, j + rows_local, j), 0,
                            rows_local - 1)
            else:
                j = j - lo
                j = np.where((j >= 0) & (j < rows_local), j, -1)
            for x in range(threads):
                e = np.arange(x, rows * width, threads)
                r = e // width
                src = j[r]
                at = row0 * width + e
                keep = at < dst.size          # a faulty width's overrun
                dst[at[keep]] = np.where(
                    src >= 0, src_flat[np.maximum(src, 0) * width + e -
                                       r * width], 0.0)[keep]
        outs.append(dst.reshape((bsz,) + data.shape[1:]))
    return outs


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("rows_per_block", [128, 16])
def test_ring_gather_kernel_index_math(case, rows_per_block):
    """The kernel's grid and index rule, emulated in numpy, give what the
    plain versions give, for every field; 16 rows a block makes the
    74-row batch span several blocks, the last one ragged."""
    rows, lo = GATHER_CASES[case]
    rng = np.random.default_rng(rows * 3 + (lo or 0))
    datas, idx = _gather_inputs(rng, rows, lo)
    got = emulate_ring_gather_kernel(datas, idx, lo or 0,
                                     rows_per_block=rows_per_block)
    kw = {} if lo is None else {"window_start": lo}
    want = rops.ring_gather_fields_ref([t(d) for d in datas], t(idx), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, n(w))


@pytest.mark.parametrize("mutation", ["field_width", "row_offset",
                                      "no_window"])
def test_ring_gather_kernel_emulation_catches_a_fault(mutation):
    """The emulation above is strict enough to catch a faulty kernel: a
    field width off by one, an index off by one, a window not applied."""
    rows, lo = GATHER_CASES["window"]
    rng = np.random.default_rng(7)
    datas, idx = _gather_inputs(rng, rows, lo)
    want = rops.ring_gather_fields_ref([t(d) for d in datas], t(idx),
                                       window_start=lo)
    widths = [d.size // rows for d in datas]
    if mutation == "field_width":
        widths[0] -= 1
    got = emulate_ring_gather_kernel(
        datas, idx + (mutation == "row_offset"),
        0 if mutation == "no_window" else lo, widths=widths)
    assert not all(np.array_equal(g, n(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("fields", [0, 9])
def test_ring_gather_fields_count_raises(fields):
    """1 to 8 fields a gather, as the kernel's binding takes."""
    datas = [torch.zeros(4, 2) for _ in range(fields)]
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{fields} fields: takes 1 to 8"):
        rops.ring_gather_fields_ref(datas, idx)
    if fields:
        with pytest.raises(ValueError, match="takes 1 to 8"):
            kops.ring_gather_fields(datas, idx)


def test_ring_gather_fields_refuses_cpu_tensors():
    """The one-launch gather refuses a pool off the card before anything
    is built, as the one-field wrapper does."""
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_gather_fields([torch.zeros(8, 3), torch.zeros(8)],
                                torch.zeros(4, dtype=torch.int32))
