"""Row 11's sm90 kernel, on the CPU.

``csrc/istft.cu``'s ``istft_sm90_kernel`` takes the inverse DFT of 64
frames at a time as one product on the tensor cores in 3xTF32 (the spectra
and the K-major basis split into TF32 hi and lo, K padded with zeros to a
multiple of 8, three products summed in fp32), walks each block's run of
output slots in tiles of 64 frames that start on 4-frame groups of the flat
spectra (1-D bulk copies need 16-byte starts and sizes; the threads load the
last floats where the spectra end off 16 bytes), carries the frames a tile's
first slots need from the tile before in a ring of 96 frame rows, and
reads the envelope from a table of one period and its edges.  A torch
emulation of those steps holds the kernel's arithmetic and its walk within
the tolerance the card is held to (``chip_smoke.py``'s ``TOL["istft"]``) of
the plain version and of JAX's Pallas kernel in interpret mode; the table is
shown bit-equal to ``istft_inverse_envelope``, and the shape gate is
checked.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from styletts_zs_torch.kernels import istft as istft_k
from styletts_zs_torch.ops import stft as stft_ops
from styletts_zs_tpu.kernels import vocoder_kernels
from test_torch_fp32_split import split

# chip_smoke.py's TOL["istft"][float32]: |out - ref| <= atol + rtol |ref|
ATOL, RTOL = 1e-5, 1e-5
TILE, RING = 64, 96    # frames a product; frame rows of the ring


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def walk(B: int, F: int, n_fft: int, hop: int, grid: int):
    """The kernel's tiles, block by block: (block, b, c0, c1, a).  Block k
    takes the slots [k T / grid, (k + 1) T / grid) of the T = B S of all
    rows, row by row; in a row, the slots [c0, c1) in tiles of 64 frames
    from a, the first a at the (M - 1)th frame before c0, moved down so that
    the flat index b F + a is a multiple of 4."""
    M = (n_fft - 1) // hop + 1
    s_lo, S = istft_k.sm90_slots(n_fft, hop, F)
    total = B * S
    for k in range(grid):
        g, g1 = total * k // grid, total * (k + 1) // grid
        while g < g1:
            b, c = divmod(g, S)
            c0 = s_lo + c
            c1 = c0 + min(g1 - g, S - c)
            g += c1 - c0
            row = b * F
            a = ((row + c0 - (M - 1)) & ~3) - row
            while a < c1:
                yield k, b, c0, c1, a
                a += TILE


def plan(b: int, a: int, F: int, n_freq: int, n_floats: int):
    """The kernel's copies of the tile at frame a of row b (``plan``)."""
    c = SimpleNamespace(src=0, dst=0, bytes=0, tail_src=0, tail_dst=0,
                        tail_n=0)
    row = b * F
    fa = row + a
    lo, hi = max(fa, row & ~3), min(fa + TILE, row + F)
    if hi <= lo:
        return c
    end4 = n_floats & ~3
    f_lo, f_hi = lo * n_freq, ((hi + 3) & ~3) * n_freq
    c.src, c.dst = f_lo, f_lo - fa * n_freq
    c.bytes = max(4 * (min(f_hi, end4) - f_lo), 0)
    t_lo, t_hi = max(f_lo, end4), min(hi * n_freq, n_floats)
    if t_hi > t_lo:
        c.tail_src, c.tail_dst, c.tail_n = t_lo, t_lo - fa * n_freq, \
            t_hi - t_lo
    return c


def istft_sm90_emulated(real, imag, *, n_fft: int, hop: int,
                        grid: int) -> torch.Tensor:
    """The sm90 kernel's function in its steps, (B, (F-1) hop) fp32: each
    tile's spectra as its copies leave them in the stage (the rest NaN, so
    a frame the copies miss shows), 3xTF32 products, the frame ring, the
    overlap-add in the kernel's order and the envelope table.  Fails if a
    slot is written twice or never, or a sample needs a frame the ring no
    longer holds."""
    B, F, nf = real.shape
    K = 2 * nf
    Kp = -(-K // 8) * 8
    M = (n_fft - 1) // hop + 1
    syn = torch.zeros(Kp, n_fft)
    syn[:K] = torch.as_tensor(stft_ops.istft_synthesis_basis(n_fft, n_fft))
    b_hi, b_lo = split(syn)
    table, Fc = istft_k.envelope_table(n_fft, hop, F)
    table = torch.as_tensor(table)
    flat = torch.stack([real.reshape(-1), imag.reshape(-1)]).float()
    n_floats = B * F * nf
    out_len = (F - 1) * hop
    out = torch.full((B * out_len,), float("nan"))
    block = None
    for k, b, c0, c1, a in walk(B, F, n_fft, hop, grid):
        if k != block:
            block = k
            ring = torch.full((RING, n_fft), float("nan"))
            held = torch.full((RING,), -10 ** 9, dtype=torch.long)
        c = plan(b, a, F, nf, n_floats)
        assert c.bytes % 16 == 0 and c.src % 4 == 0 and c.dst % 4 == 0
        assert c.src + c.bytes // 4 <= (n_floats & ~3) and c.tail_n <= 3
        stage = torch.full((2, TILE * nf), float("nan"))
        stage[:, c.dst:c.dst + c.bytes // 4] = \
            flat[:, c.src:c.src + c.bytes // 4]
        stage[:, c.tail_dst:c.tail_dst + c.tail_n] = \
            flat[:, c.tail_src:c.tail_src + c.tail_n]
        frames = a + torch.arange(TILE)
        valid = (frames >= 0) & (frames < F)
        st = stage.view(2, TILE, nf)
        A = torch.cat([st[0], st[1], torch.zeros(TILE, Kp - K)], dim=1)
        A[~valid] = 0.0
        assert not torch.isnan(A).any(), "a frame of the row was not copied"
        a_hi, a_lo = split(A)
        rows = frames % RING
        ring[rows] = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
        held[rows] = frames
        e0, e1 = max(c0, a), min(a + TILE, c1)
        o0 = max(e0 * hop - n_fft // 2, 0)
        o1 = min(e1 * hop - n_fft // 2, out_len)
        if o1 <= o0:
            continue
        s = torch.arange(o0, o1) + n_fft // 2
        f, phi = s // hop, s % hop
        acc = torch.zeros(o1 - o0)
        for m in range(M):
            use = phi + m * hop < n_fft
            r = (f - m) % RING
            assert torch.equal(held[r][use], (f - m)[use])
            acc = acc + torch.where(
                use, ring[r, (phi + m * hop).clamp(max=n_fft - 1)], 0.0)
        j = torch.where(f < F, f.clamp(max=M - 1), f - F + Fc)
        idx = (j * hop + phi).clamp(max=len(table) - 1)
        val = torch.where(phi < n_fft, acc * table[idx], 0.0)
        dst = b * out_len + torch.arange(o0, o1)
        assert torch.isnan(out[dst]).all(), "a sample written twice"
        out[dst] = val
    assert not torch.isnan(out).any(), "a sample never written"
    return out.view(B, out_len)


def _spectra(n_fft: int, B: int, F: int, seed: int):
    rs = np.random.default_rng(seed)
    nf = n_fft // 2 + 1
    return (rs.standard_normal((B, F, nf)).astype(np.float32),
            rs.standard_normal((B, F, nf)).astype(np.float32))


# F = 100 (0 mod 4), 101, 10 and 130 (2), 103 (3), 2 (the least): with B 3
# and an odd n_freq, B F n_freq ends 0-3 floats past 16 bytes.  Grid 5
# splits rows between blocks; at F 10 one block a slot.
_CASES = [(nf, h, F) for nf, h in ((48, 12), (16, 4))
          for F in (2, 10, 100, 101, 103, 130)]


@pytest.mark.parametrize("n_fft,hop,F", _CASES)
def test_sm90_emulation_matches_plain_and_pallas(n_fft, hop, F):
    real, imag = _spectra(n_fft, 3, F, seed=F + n_fft)
    grid = 3 * istft_k.sm90_slots(n_fft, hop, F)[1] if F == 10 else 5
    out = istft_sm90_emulated(t(real), t(imag), n_fft=n_fft, hop=hop,
                              grid=grid)
    ref = istft_k.istft_plain(t(real), t(imag), n_fft=n_fft, hop=hop)
    assert out.shape == ref.shape == (3, (F - 1) * hop)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=RTOL)
    pal = vocoder_kernels.istft_pallas(jnp.asarray(real), jnp.asarray(imag),
                                       n_fft=n_fft, hop=hop)
    np.testing.assert_allclose(n(out), np.asarray(pal), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_fft,hop,F,grid", [
    (48, 5, 101, 3),      # hop no divisor of n_fft
    (64, 2, 300, 4),      # M = 32: the ring carries 31 frames, all it can
    (32, 8, 103, 1),      # one block walks every row
    (16, 20, 50, 7),      # hop > n_fft: samples no frame reaches
])
def test_sm90_emulation_at_other_geometries(n_fft, hop, F, grid):
    real, imag = _spectra(n_fft, 2, F, seed=hop)
    out = istft_sm90_emulated(t(real), t(imag), n_fft=n_fft, hop=hop,
                              grid=grid)
    ref = istft_k.istft_plain(t(real), t(imag), n_fft=n_fft, hop=hop)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=RTOL)


def test_3xtf32_is_needed_at_the_head_geometry():
    """One TF32 product alone misses the tolerance by far: the split is what
    keeps the kernel at fp32's."""
    real, imag = _spectra(48, 2, 100, seed=5)
    A = torch.cat([t(real), t(imag)], dim=-1)
    syn = torch.as_tensor(stft_ops.istft_synthesis_basis(48, 48))
    exact = A.double() @ syn.double()
    a_hi, a_lo = split(A)
    s_hi, s_lo = split(syn)
    three = a_hi @ s_hi + a_hi @ s_lo + a_lo @ s_hi
    one = a_hi @ s_hi
    assert (three.double() - exact).abs().max() < ATOL / 10
    assert (one.double() - exact).abs().max() > ATOL


@pytest.mark.parametrize("n_fft,hop", [(48, 12), (16, 4), (32, 8), (64, 16),
                                       (48, 5), (64, 1), (16, 20), (48, 48)])
def test_envelope_table_is_bit_equal_to_the_envelope(n_fft, hop):
    """The kernel's read of the table at sample s = f hop + phi equals
    ``istft_inverse_envelope``'s value to the bit, at the path shapes' frame
    counts and at every count below 2 M; where phi >= n_fft (hop > n_fft)
    no frame reaches the sample and the envelope is 1e8."""
    M = (n_fft - 1) // hop + 1
    for F in sorted({*range(2, 2 * M + 3), 10, 100, 25600, 121600}):
        inv = stft_ops.istft_inverse_envelope(n_fft, hop, F)
        table, Fc = istft_k.envelope_table(n_fft, hop, F)
        assert Fc == min(F, M) and len(table) == (Fc - 1) * hop + n_fft
        assert table.dtype == inv.dtype == np.float32
        s = np.arange(len(inv))
        f, phi = s // hop, s % hop
        j = np.where(f < F, np.minimum(f, M - 1), f - F + Fc)
        reach = phi < n_fft
        got = table[(j * hop + phi)[reach]]
        assert np.array_equal(got.view(np.int32), inv[reach].view(np.int32))
        assert (inv[~reach] == np.float32(1e8)).all()


@pytest.mark.parametrize("n_fft,hop", [(48, 12), (16, 4), (48, 5), (16, 20)])
def test_sm90_slots_cover_the_trimmed_output(n_fft, hop):
    """Slots s_lo .. s_lo + S - 1 hold the output samples n_fft//2 ..
    n_fft//2 + (F-1) hop - 1 and no slot lies wholly outside them."""
    for F in (2, 3, 10, 101):
        s_lo, S = istft_k.sm90_slots(n_fft, hop, F)
        first, end = n_fft // 2, n_fft // 2 + (F - 1) * hop
        assert s_lo * hop <= first < (s_lo + 1) * hop
        assert (s_lo + S - 1) * hop < end <= (s_lo + S) * hop


def test_sm90_gate():
    """The sm90 kernel is built for the windows 16, 32, 48 and 64 (the
    vocoder head's is 48), at every hop whose M = ceil(n_fft / hop) frames
    a sample sums fit its ring beside a tile (M <= 33); the tiny test
    config's 8, every other window and hop 1 at 48 and 64 take the generic
    kernel."""
    for n_fft in (16, 32, 48, 64):
        for hop in (2, 4, 12, 100):
            assert istft_k.takes_sm90(n_fft, hop)
    assert istft_k.takes_sm90(16, 1) and istft_k.takes_sm90(32, 1)
    for n_fft, hop in ((8, 4), (24, 6), (40, 10), (128, 32), (2048, 300),
                       (48, 0), (48, 1), (64, 1)):
        assert not istft_k.takes_sm90(n_fft, hop)
    for n_fft in (16, 32, 48, 64):
        for hop in range(1, n_fft + 2):
            M = (n_fft - 1) // hop + 1
            assert istft_k.takes_sm90(n_fft, hop) == (TILE + M - 1 <= RING)
