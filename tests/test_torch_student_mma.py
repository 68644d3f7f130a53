"""The tensor-core route of the guided path kernel, on the CPU
(raytracer_tpu_torch/core/cuda_path.py, csrc/student_mma.cuh).

* ``pack_student_mma`` unpacks to the guide's own weights, zero-padded to
  32 observation rows, hidden widths to multiples of 16 and the output to
  8, with the size ``student_mma.cuh::packed_size`` gives; it is cached per
  guide and device;
* the route: bf16 students take the tensor-core kernel, f32 students the
  scalar one, and an f32 student never reaches the bf16 packing;
* the kernel's MLP emulated fragment by fragment, as PTX defines
  ``ldmatrix`` and ``mma.m16n8k16`` (each 16-deep product summed exactly,
  then rounded to f32 with the accumulator), over the packed weights and
  a compacted observation tile: one-hot students equal the plain guide
  bit for bit; the shipped student equals it, and flax's bf16 student
  under XLA, on at least 99.9% of outputs (the sums' order differs).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.fb.distill import DistilledGuide as JaxGuide
from raytracer_tpu_torch.core import cuda_path
from raytracer_tpu_torch.fb.distill import DistilledGuide
from raytracer_tpu_torch.fb.registry import STUDENTS_DIR

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = "fb_chandelier_distilled.npz"
K0, OUT = cuda_path.MMA_OBS_PAD, cuda_path.MMA_OUT_PAD


def _student(kind, width, hidden, seed=0):
    """A 22->width(->width)->2 student: ``one_hot`` (px, py, pz, nx through
    the hidden units to a0 = px, a1 = -nx) or ``random``."""
    dims = (22,) + (width,) * hidden + (2,)
    rng = np.random.RandomState(seed)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        if kind == "random":
            k = (rng.randn(a, b) / np.sqrt(a)).astype(np.float32)
            bias = (rng.randn(b) * 0.1).astype(np.float32)
        else:
            k, bias = np.zeros((a, b), np.float32), np.zeros(b, np.float32)
            if i == 0:
                for j, c in enumerate((0, 1, 2, 6)):
                    k[c, j] = 1.0
            elif i < len(dims) - 2:
                k[np.arange(b), np.arange(b)] = 1.0
            else:
                k[0, 0], k[3, 1] = 1.0, -1.0
        params[f"Dense_{i}"] = {"kernel": k, "bias": bias}
    return DistilledGuide(params, dims[1:-1])


def _unpack(packed, dims):
    """``[(kernel [K, N], bias [N]), ...]`` from ``pack_student_mma``'s
    layout, padding included: element ``(k, n)`` of a layer with ``N``
    units at ``((k // 8) * N + n) * 8 + k % 8``, then the bias."""
    n_hidden, h1, h2 = dims
    flat, layers, rows, at = packed.float(), [], K0, 0
    for out in [h1, h2][:n_hidden] + [OUT]:
        k = flat[at:at + rows * out].reshape(rows // 8, out, 8)
        layers.append((k.transpose(1, 2).reshape(rows, out),
                       flat[at + rows * out:at + rows * out + out]))
        at += rows * out + out
        rows = out
    assert at == flat.numel()
    return layers


def _packed_size(n_hidden, h1, h2):
    """csrc/student_mma.cuh::packed_size."""
    last = h2 if n_hidden == 2 else h1
    n = K0 * h1 + h1 + (h1 * h2 + h2 if n_hidden == 2 else 0)
    return n + last * OUT + OUT


@pytest.mark.parametrize("width,hidden", [
    (128, 2), (24, 2), (128, 1), (40, 1), (8, 2), (17, 2), (100, 1)])
def test_mma_packing_unpacks_to_the_guides_weights(width, hidden):
    guide = _student("random", width, hidden).as_guide_fn()
    dims = cuda_path.student_dims_mma(guide)
    pad = -(-width // 16) * 16
    assert dims == (hidden, pad, pad if hidden == 2 else 0)
    packed = cuda_path.pack_student_mma(guide, "cpu")
    assert packed.dtype == torch.bfloat16 and packed.dim() == 1
    assert packed.numel() == _packed_size(*dims)
    layers = _unpack(packed, dims)
    rows = K0
    for (k, b), (gk, gb) in zip(layers, guide.layers):
        out = OUT if gk.shape[1] == 2 else pad
        assert k.shape == (rows, out) and b.shape == (out,)
        assert torch.equal(k[:gk.shape[0], :gk.shape[1]], gk)
        assert torch.equal(b[:gb.shape[0]], gb)
        assert not k[gk.shape[0]:].any() and not k[:, gk.shape[1]:].any()
        assert not b[gb.shape[0]:].any()
        rows = out
    # Element (k, n) of a layer with N units: ((k // 8) * N + n) * 8 + k % 8.
    w0 = packed[:K0 * pad].float().reshape(K0 // 8, pad, 8)
    assert torch.equal(w0[1, 5, 3], layers[0][0][8 + 3, 5])


def test_mma_packing_is_cached_per_guide_and_device():
    guide = _student("random", 24, 2).as_guide_fn()
    a = cuda_path.pack_student_mma(guide, "cpu")
    assert cuda_path.pack_student_mma(guide, torch.device("cpu")) is a
    other = _student("random", 24, 2).as_guide_fn()
    assert cuda_path.pack_student_mma(other, "cpu") is not a
    m = cuda_path.pack_student_mma(guide, "meta")
    assert m.device.type == "meta" and m is not a
    assert cuda_path.pack_student_mma(guide, "meta") is m


def test_route_picks_tensor_cores_for_bf16_and_scalar_for_f32():
    d = DistilledGuide.load(STUDENTS_DIR / SHIPPED)
    assert cuda_path.guided_route(d.as_guide_fn()) == "bf16_mma"
    assert cuda_path.guided_route(d.as_guide_fn("auto")) == "bf16_mma"
    assert cuda_path.guided_route(d.as_guide_fn(torch.bfloat16)) == \
        "bf16_mma"
    assert cuda_path.guided_route(d.as_guide_fn(None)) == "f32"
    with pytest.raises(ValueError, match="student"):
        cuda_path.guided_route(lambda obs: obs[:, :2])
    with pytest.raises(ValueError):
        cuda_path.guided_route(_student("random", 129, 1).as_guide_fn())


def test_f32_student_never_reaches_the_bf16_packing(monkeypatch):
    f32 = _student("random", 24, 2).as_guide_fn(dtype=None)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_path.pack_student_mma(f32, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the other route's packing was reached")

    monkeypatch.setattr(cuda_path, "pack_student_mma", refuse)
    ptr, n_hidden, h1, h2 = cuda_path.student_args(f32, "f32", "cpu")
    assert ptr == cuda_path.pack_student(f32, "cpu").data_ptr()
    assert (n_hidden, h1, h2) == (2, 24, 24)
    monkeypatch.undo()
    bf16 = _student("random", 24, 2).as_guide_fn()
    monkeypatch.setattr(cuda_path, "pack_student", refuse)
    ptr, n_hidden, h1, h2 = cuda_path.student_args(bf16, "bf16_mma", "cpu")
    assert ptr == cuda_path.pack_student_mma(bf16, "cpu").data_ptr()
    assert (n_hidden, h1, h2) == (2, 32, 32)
    assert cuda_path.student_args(None, "unguided", "cpu") == (None, 0, 0, 0)


# --- the kernel's MLP, fragment by fragment --------------------------------

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4       # groupID, thread in group


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


def _ldmatrix(mem, addrs, n):
    """``ldmatrix.m8n8.x{n}``: lanes 8j..8j+7 address matrix j's rows; lane
    l gets row l // 4, columns 2 (l % 4) and 2 (l % 4) + 1, of each."""
    a = np.asarray(addrs)
    return np.stack([np.stack([mem[a[8 * j + G] + 2 * T],
                               mem[a[8 * j + G] + 2 * T + 1]], -1)
                     for j in range(n)], 1)            # [lane, reg, half]


def _mma(c, a, b):
    """``mma.m16n8k16`` f32 += bf16 bf16 from the PTX fragment layouts."""
    A, B, C = np.zeros((16, 16)), np.zeros((16, 8)), np.zeros((16, 8))
    for half in (0, 1):
        A[G, 2 * T + half] = a[:, 0, half]
        A[G + 8, 2 * T + half] = a[:, 1, half]
        A[G, 2 * T + 8 + half] = a[:, 2, half]
        A[G + 8, 2 * T + 8 + half] = a[:, 3, half]
        B[2 * T + half, G] = b[:, 0, half]
        B[2 * T + 8 + half, G] = b[:, 1, half]
        C[G, 2 * T + half] = c[:, half]
        C[G + 8, 2 * T + half] = c[:, 2 + half]
    D = (A @ B + C).astype(np.float32)
    return np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T],
                     D[G + 8, 2 * T + 1]], -1)


def _hidden2(x, bias):
    """``hidden2``: round to bf16, add the bias in bf16, ReLU."""
    y = _bf16(_bf16(x) + bias)
    return np.where(np.isnan(y), y, np.maximum(y, 0.0)).astype(np.float32)


def _hidden_to_a(c0, c1, bias):
    b0 = np.stack([bias[2 * T], bias[2 * T + 1]], -1)
    b1 = np.stack([bias[8 + 2 * T], bias[9 + 2 * T]], -1)
    return np.stack([_hidden2(c0[:, 0:2], b0), _hidden2(c0[:, 2:4], b0),
                     _hidden2(c1[:, 0:2], b1), _hidden2(c1[:, 2:4], b1)], 1)


def _mtile(w, tile, dims, mt):
    """``smma::mtile``: the output fragment of m-tile ``mt``."""
    n_hidden, h1, h2 = dims
    o_b0 = K0 * h1
    o_w1 = o_b0 + h1
    o_b1 = o_w1 + h1 * h2
    o_wo = o_b1 + h2 if n_hidden == 2 else o_w1
    o_bo = o_wo + (h2 if n_hidden == 2 else h1) * OUT
    q, r = LANE >> 3, LANE & 7

    def load_b(base, n, ks, n0):
        return _ldmatrix(w, base + ((2 * ks + (q & 1)) * n + n0
                                    + (q >> 1) * 8 + r) * 8, 4)

    def load_b_out(ks):
        return _ldmatrix(w, o_wo + ((2 * ks + (q & 1)) * OUT + r) * 8, 2)

    x = [_ldmatrix(tile, ((2 * ks + (q >> 1)) * 32 + 16 * mt + (q & 1) * 8
                          + r) * 8, 4) for ks in range(K0 // 16)]
    zero = np.zeros((32, 4), np.float32)
    h = []
    for s in range(h1 // 16):
        c0, c1 = zero, zero
        for ks in range(K0 // 16):
            b = load_b(0, h1, ks, 16 * s)
            c0, c1 = _mma(c0, x[ks], b[:, 0:2]), _mma(c1, x[ks], b[:, 2:4])
        h.append(_hidden_to_a(c0, c1, w[o_b0 + 16 * s:]))
    out = zero
    if n_hidden == 2:
        for s in range(h2 // 16):
            c0, c1 = zero, zero
            for ks in range(h1 // 16):
                b = load_b(o_w1, h2, ks, 16 * s)
                c0, c1 = _mma(c0, h[ks], b[:, 0:2]), _mma(c1, h[ks],
                                                          b[:, 2:4])
            out = _mma(out, _hidden_to_a(c0, c1, w[o_b1 + 16 * s:]),
                       load_b_out(s))
    else:
        for ks in range(h1 // 16):
            out = _mma(out, h[ks], load_b_out(ks))
    bo = np.stack([w[o_bo + 2 * T], w[o_bo + 2 * T + 1]], -1)
    return (_bf16(out) + np.concatenate([bo, bo], -1)).astype(np.float32)


def _warp_actions(guide, obs, guided):
    """The warp's level: compaction by ballot into the tile (guided rows
    first, zero rows after), one m-tile per 16 guided lanes, each lane's
    action from the lane holding its row.  Returns ``[32, 2]``."""
    dims = cuda_path.student_dims_mma(guide)
    w = cuda_path.pack_student_mma(guide, "cpu").float().numpy()
    n = int(guided.sum())
    below = np.cumsum(guided) - guided
    row = np.where(guided, below, n + (LANE - below))
    tile = np.zeros(32 * K0, np.float32)
    vals = np.where(guided[:, None], _bf16(obs), 0.0)
    for k in range(22):
        tile[((k // 8) * 32 + row) * 8 + k % 8] = vals[:, k]
    act = np.zeros((32, 2), np.float32)
    for mt in range(2 if n > 16 else 1):
        out = _mtile(w, tile, dims, mt)
        src = (row & 7) * 4
        v = out[src]
        mine = (row >> 4) == mt
        low = (row & 15) < 8
        act[mine] = np.where(low[:, None], v[:, 0:2], v[:, 2:4])[mine]
    return act


def _masks(seed):
    rng = np.random.RandomState(seed)
    return [np.ones(32, bool), rng.rand(32) < 0.5, LANE == 31,
            (LANE % 3) == 0, LANE >= 8]


@pytest.mark.parametrize("width,hidden", [(128, 2), (24, 2), (128, 1)])
def test_emulated_mma_mlp_equals_plain_one_hot(width, hidden):
    guide = _student("one_hot", width, hidden).as_guide_fn()
    rng = np.random.RandomState(width + hidden)
    for m in _masks(hidden):
        obs = (rng.randn(32, 22) * 3).astype(np.float32)
        want = guide(torch.from_numpy(obs)).numpy()
        got = _warp_actions(guide, obs, m)
        np.testing.assert_array_equal(got[m], want[m])


def test_emulated_mma_mlp_matches_the_shipped_student():
    guide = DistilledGuide.load(STUDENTS_DIR / SHIPPED).as_guide_fn()
    flax = JaxGuide.load(ROOT / "models" / SHIPPED).as_guide_fn()
    rng = np.random.RandomState(5)
    got, want, ref = [], [], []
    for i in range(16):
        m = _masks(i)[i % 5]
        obs = (rng.rand(32, 22) * 8 - 4).astype(np.float32)
        got.append(_warp_actions(guide, obs, m)[m])
        want.append(guide(torch.from_numpy(obs)).numpy()[m])
        ref.append(np.asarray(flax(jnp.asarray(obs)))[m])
    got, want, ref = map(np.concatenate, (got, want, ref))
    assert np.isfinite(got).all() and got.shape[0] > 200
    assert (got == want).mean() >= 0.999
    assert (got == ref).mean() >= 0.999
