"""The hoisted formulation of the focus estimate (ops/focus_torch.py:
cheby_map, clean_flags, estimate_hoisted), which the CUDA kernels of
ops/focus_estimate.py run, on the CPU in plain PyTorch.

Tolerance: none, bytes equal. Costs are exact integers and the map is an
argmin over them, so the hoisted estimate must be torch.equal to
focus_torch.estimate_focus_map (the plain version the kernels are held
against on the card) for both tap rules, and the fast rule byte-equal to the
JAX package's focus.estimate_focus_map(exact_taps=False) (XLA on the CPU)
on the same seeded numpy inputs. clean_flags is held against a brute-force
NumPy float32 loop.
"""

import numpy as np
import pytest
import torch

from lfinterpolator_tpu_torch.ops import focus_estimate, focus_torch
from lfinterpolator_tpu_torch.ops.estimate_geometry import FocusTables
from lfinterpolator_tpu_torch.state import focus_tables
from lfinterpolator_tpu_torch.utils import profiling

from test_torch_focus import CASES  # the scenes and the two sides, shared
from test_torch_focus import _case as case
from test_torch_focus import _jax_xla as jax_xla
from test_torch_focus import _port_operands as port_operands

torch.set_num_threads(1)


def _synthetic(k, h, w, steps, focus, frange, shifts=None, reach=20.0, seed=0):
    """Seeded views with free-standing offsets -> (selected, sel_offsets,
    tables). `shifts` [K] places candidate 0's shift f0 * o_k of view k at
    -shifts[k] in both axes, so that view's coordinate changes sign there."""
    rng = np.random.default_rng(seed)
    selected = torch.from_numpy(rng.integers(0, 256, (k, 3, h, w), dtype=np.uint8))
    if shifts is None:
        offsets = ((rng.random((k, 2)) - 0.5) * 2 * reach).astype(np.float32)
    else:
        o = -np.asarray(shifts, np.float32) / np.float32(focus)
        offsets = np.stack([o, o], axis=1)
    tables = FocusTables(*(torch.from_numpy(t) for t in focus_tables(focus, frange, steps)))
    return selected, torch.from_numpy(offsets), tables


# name -> (operands, radius): the geometries the kernels' flags must get right
def _extra(name):
    if name == "all_dirty":
        # a view's sign change every 3 pixels, radius 3 and 2, and a range
        # that moves no shift by half a pixel: every candidate, row and
        # column has a view within reach
        shifts = 0.5 + 3.0 * np.arange(16)
        return _synthetic(16, 24, 40, 3, 1.0, 0.01, shifts), (3, 2)
    return {
        "radius0": lambda: (_synthetic(4, 20, 30, 5, 0.1, 0.3), (0, 0)),
        "narrower_than_radius": lambda: (_synthetic(3, 9, 7, 4, 0.2, 0.5, reach=8.0), (10, 12)),
        "shorter_than_radius": lambda: (_synthetic(3, 5, 30, 4, -0.2, 0.5, reach=8.0), (2, 9)),
        "k1": lambda: (_synthetic(1, 21, 33, 4, 0.2, 0.3), (2, 2)),
        "steps2": lambda: (_synthetic(4, 18, 26, 2, -0.1, 0.6), (3, 1)),
        "steps33": lambda: (_synthetic(3, 14, 22, 33, 0.1, 0.3, reach=40.0), (2, 2)),
        "far_shifts": lambda: (_synthetic(4, 16, 24, 4, 30.0, 20.0), (4, 2)),
    }[name]()


EXTRA = ["all_dirty", "radius0", "narrower_than_radius", "shorter_than_radius", "k1",
         "steps2", "steps33", "far_shifts"]


def _operands(name):
    if name in CASES:
        *scene, radius = case(name)
        return port_operands(*scene), radius
    return _extra(name)


ALL = sorted(CASES) + EXTRA


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", ALL)
def test_hoisted_estimate_equals_plain_estimate(name, exact):
    operands, radius = _operands(name)
    got = focus_torch.estimate_hoisted(*operands, radius, exact)
    assert got.dtype == torch.uint8 and got.shape == operands[0].shape[2:]
    assert torch.equal(got, focus_torch.estimate_focus_map(*operands, radius, exact))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hoisted_fast_rule_equals_jax_fast_sweep(name):
    *scene, radius = case(name)
    got = focus_torch.estimate_hoisted(*port_operands(*scene), radius, False)
    np.testing.assert_array_equal(got.numpy(), jax_xla(*scene, radius, False))


def _clean_brute_force(n, r, shifts):
    """[S, n] bool by a scalar float32 loop: every operation rounded on its
    own, no vector op shared with clean_flags."""
    out = np.ones((shifts.shape[0], n), dtype=bool)
    for i in range(shifts.shape[0]):
        for q in range(n):
            for sh in shifts[i]:
                center = np.trunc(np.float32(q) + sh)
                for s in (-r, 0, r):
                    tap = np.trunc(np.float32(q + s) + sh)
                    if np.float32(center + np.float32(s)) != tap:
                        out[i, q] = False
    return out


@pytest.mark.parametrize("name", ALL)
def test_clean_flags_match_a_brute_force_loop(name):
    (selected, offsets, tables), radius = _operands(name)
    h, w = selected.shape[2:]
    rows, cols = focus_torch.clean_flags(offsets, tables, radius, h, w)
    steps = tables.candidates.shape[0]
    assert rows.dtype == cols.dtype == torch.bool
    assert tuple(rows.shape) == (steps, h) and tuple(cols.shape) == (steps, w)
    shift = tables.candidates.numpy()[:, None, None] * offsets.numpy()[None]  # [S, K, 2] f32
    assert shift.dtype == np.float32
    np.testing.assert_array_equal(rows.numpy(), _clean_brute_force(h, radius[1], shift[..., 1]))
    np.testing.assert_array_equal(cols.numpy(), _clean_brute_force(w, radius[0], shift[..., 0]))


def test_flags_of_the_named_geometries():
    """The cases are what their names say: every pair dirty, every pair
    clean (radius 0; shifts far outside the frame), and a mix."""
    share = {}
    for name in ("all_dirty", "radius0", "far_shifts", "sign_change"):
        (selected, offsets, tables), radius = _operands(name)
        rows, cols = focus_torch.clean_flags(offsets, tables, radius, *selected.shape[2:])
        share[name] = float((rows[:, :, None] & cols[:, None, :]).float().mean())
    assert share["all_dirty"] == 0.0
    assert share["radius0"] == share["far_shifts"] == 1.0
    assert 0.5 < share["sign_change"] < 1.0


def test_clean_flags_in_chunks_of_candidates(monkeypatch):
    """The temporaries' cap changes nothing."""
    (selected, offsets, tables), radius = _operands("steps33")
    h, w = selected.shape[2:]
    want = focus_torch.clean_flags(offsets, tables, radius, h, w)
    monkeypatch.setattr(focus_torch, "_FLAG_ELEMENTS", 100)  # 1 candidate a chunk
    got = focus_torch.clean_flags(offsets, tables, radius, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", ALL)
def test_cheby_map_slices_sum_to_the_fast_cost(name):
    (selected, offsets, tables), radius = _operands(name)
    k, _, h, w = selected.shape
    rx, ry = radius
    for f in tables.candidates[[0, -1]]:
        d = focus_torch.cheby_map(selected, offsets, f, radius)
        assert d.dtype == torch.uint8 and tuple(d.shape) == (h + 2 * ry, w + 2 * rx)
        want = focus_torch.candidate_cost(selected, offsets, f, radius, False)
        assert torch.equal(focus_torch.hoisted_cost(d, h, w, radius), want)
        assert int(want.max()) <= 9 * 255


def test_cheby_map_is_the_spread_at_the_clamped_coordinates():
    """One candidate, element by element, against a NumPy loop."""
    (selected, offsets, tables), radius = _operands("narrower_than_radius")
    k, c, h, w = selected.shape
    rx, ry = radius
    f = tables.candidates[1]
    d = focus_torch.cheby_map(selected, offsets, f, radius).numpy()
    sel, off, fv = selected.numpy().astype(int), offsets.numpy(), np.float32(f)
    for qy in range(-ry, h + ry):
        for qx in range(-rx, w + rx):
            ys = [int(np.clip(np.trunc(np.float32(qy) + fv * off[v, 1]), 0, h - 1))
                  for v in range(k)]
            xs = [int(np.clip(np.trunc(np.float32(qx) + fv * off[v, 0]), 0, w - 1))
                  for v in range(k)]
            px = np.stack([sel[v, :, ys[v], xs[v]] for v in range(k)])  # [K, C]
            assert d[qy + ry, qx + rx] == (px.max(0) - px.min(0)).max()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_estimate_wrapper_and_its_parts_on_cpu(exact):
    """On CPU tensors the wrapper takes the plain versions: no kernel is
    counted, the flagged entry ignores its flags, cheby_maps stacks
    cheby_map."""
    (selected, offsets, tables), radius = _operands("sign_change")
    h, w = selected.shape[2:]
    before = profiling.launch_counts()
    want = focus_torch.estimate_focus_map(selected, offsets, tables, radius, exact)
    assert torch.equal(focus_estimate.focus_estimate(selected, offsets, tables, radius, exact),
                       want)
    if exact:
        steps = tables.candidates.shape[0]
        dirty = (torch.zeros((steps, h), dtype=torch.bool),
                 torch.zeros((steps, w), dtype=torch.bool))
        assert torch.equal(focus_estimate.focus_estimate_flagged(
            selected, offsets, tables, radius, dirty), want)
        with pytest.raises(ValueError, match="flags must be bool"):
            focus_estimate.focus_estimate_flagged(
                selected, offsets, tables, radius, (dirty[0][:1], dirty[1]))
    maps = focus_estimate.cheby_maps(selected, offsets, tables, radius)
    assert tuple(maps.shape) == (tables.candidates.shape[0], h + 2 * radius[1],
                                 w + 2 * radius[0])
    assert torch.equal(maps[2], focus_torch.cheby_map(
        selected, offsets, tables.candidates[2], radius))
    assert profiling.launch_counts() == before
