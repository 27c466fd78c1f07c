"""The port's H100 probes (gaussian_splatterer_tpu_torch.scripts): the plain
twins of kernels K6-K8 against the arithmetic of the JAX package's probe
scripts, written in numpy (their Pallas kernels are nested in main() and
two of the scripts need the TPU backend at import): ``tab[:, ids]``; ``y =
y * x + 0.3`` kk times; ``exp(-y) * 0.5`` 16 times.

The kernels' tests (marker ``cuda``) hold each against its plain twin on a
card and skip here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

from gaussian_splatterer_tpu_torch.scripts import gather_probe as gp
from gaussian_splatterer_tpu_torch.scripts import peak_probe as pp
from gaussian_splatterer_tpu_torch.scripts import redesign_variants as rv
from gaussian_splatterer_tpu_torch.scripts import smem_gather_probe as sp
from gaussian_splatterer_tpu_torch.scripts.common import bound_ms

PROBES = (gp, pp, sp)


def numpy_chain(x, form, kk):
    """The probe script's kern body in numpy float32."""
    x = x.astype(np.float32)
    y = x
    f32 = np.float32
    if form == "fma":
        for _ in range(kk):
            y = y * x + f32(0.3)
    elif form == "fma_ilp":
        acc = [y * f32(0.9 + 0.01 * i) for i in range(8)]
        for _ in range(kk // 8):
            acc = [a * x + f32(0.3) for a in acc]
        y = sum(acc[1:], acc[0])
    elif form in ("exp_ilp", "fast_exp_ilp"):
        acc = [y * f32(0.9 + 0.01 * i) for i in range(4)]
        for _ in range(kk // 4):
            acc = [np.exp(-a) * f32(0.5) for a in acc]
        y = acc[0] + acc[1] + acc[2] + acc[3]
    elif form == "exp":
        for _ in range(kk):
            y = np.exp(-y) * f32(0.5)
    else:
        for _ in range(kk):
            y = np.log(y * f32(0.5) + f32(1.5))
    return y


# -- K8, the peak probe -----------------------------------------------------------


@pytest.mark.parametrize("form,kk", [("fma", 64), ("fma_ilp", 64), ("exp", 16),
                                     ("exp_ilp", 16), ("fast_exp_ilp", 16), ("log", 16),
                                     ("fma_ilp", 1024)])
def test_peak_plain_twin_is_the_script_arithmetic(form, kk):
    x = pp.probe_input((4, 32, 16), form, "cpu")
    y = pp.peak(x, form, kk)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), numpy_chain(x.numpy(), form, kk), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("form", ["exp_bf16", "log_bf16"])
def test_peak_bf16_twin_rounds_each_step(form):
    """bf16 forms round every step to bf16: within a few bf16 steps (2^-8)
    of the float32 chain, and the result keeps the input's type."""
    x = pp.probe_input((256,), form, "cpu")
    y = pp.peak(x, form, 16)
    assert y.dtype == torch.bfloat16
    ref = numpy_chain(x.float().numpy(), form.removesuffix("_bf16"), 16)
    np.testing.assert_allclose(y.float().numpy(), ref, atol=2e-2)


def test_the_script_log_chain_leaves_the_domain():
    """Why the port's log chain adds 1.5: the TPU script's y = log(y * 0.5 +
    0.8) has no fixed point (e^y > 0.8 + y / 2 for every y), so from the
    probe's inputs it takes the log of a negative number at step 13."""
    y = np.float64(0.55)
    steps = 0
    while y * 0.5 + 0.8 > 0:
        y = np.log(y * 0.5 + 0.8)
        steps += 1
    assert steps == 12
    t = np.linspace(-3, 3, 601)
    assert (np.exp(t) > 0.8 + t / 2).all()
    assert np.isfinite(numpy_chain(np.full(4, 0.55), "log", 1024)).all()


def test_peak_counts_and_checks():
    assert pp.ops("fma", 64, 10) == 2 * 64 * 10
    assert pp.ops("fma_ilp", 64, 10) == 2 * 64 * 10
    assert pp.ops("exp_ilp", 16, 10) == 16 * 10
    # the reference's shape is memory-bound: 16 FLOP a byte, under the ridge of 20
    n = np.prod(pp.REFERENCE_SHAPE)
    assert pp.ops("fma", 64, n) / (8 * n) == 16 < pp.FP32_OPS_PER_S / pp.HBM_BYTES_PER_S
    # and the register-resident form far above it
    assert pp.ops(*pp.PEAK_FORM, 1) / 8 >= 1024
    x = pp.probe_input((8,), "fma", "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        pp.peak(x, "fma_ilp", 12)
    with pytest.raises(ValueError, match="bfloat16"):
        pp.peak(x, "exp_bf16", 16)
    with pytest.raises(ValueError, match="form"):
        pp.peak(x, "tanh", 4)


def test_peak_report_says_what_bounds_each_reference_form(capsys):
    """At the reference's shape 64 FMAs an element are under the FP32 ridge
    (memory-bound); 16 exps an element are held against the ridge of the
    measured resident exp rate, and are over it.  The measured FP32 peak
    is the sustained window's rate."""
    run = dict(kk=16, shape=[8], ms=1.0, rate_per_s=1e12, bytes_per_s=1e12)
    results = {
        "reference": [dict(run, form="fma", unit="FLOP", ops_per_byte=16.0),
                      dict(run, form="exp", unit="exp", ops_per_byte=2.0)],
        "resident": [dict(run, form="exp_ilp", unit="exp", rate_per_s=3e12)],
        "window": dict(form="fma_ilp", kk=4096, launches=9, ms=1.0, rate_per_s=59e12, samples=0,
                       sm_clock_mhz="not measured", power_w="not measured",
                       power_limit_w="not measured"),
        "context": {},
    }
    pp.report(results, "card")
    fma, exp = capsys.readouterr().out.splitlines()[:2]
    assert "memory-bound" in fma and "published FP32" in fma
    assert "bound by its unit" in exp and "resident exp_ilp" in exp
    assert pp.fp32_rate(results) == 59e12


# -- K6 and K7, the gathers -------------------------------------------------------


@pytest.mark.parametrize("gather", [gp.gather_cols, sp.smem_gather])
def test_gather_twins_are_tab_ids(gather):
    """Both index layouts of the TPU probe, (D/128, 128) and (D,): the
    output takes the indices' shape, exactly numpy's tab[:, ids]."""
    tab, ids, ids_sorted = gp.probe_inputs("cpu", 16, 4096, 8192, seed=3)
    for idx in (ids, ids.view(-1, 128), ids_sorted):
        out = gather(tab, idx)
        assert out.shape == (16, *idx.shape)
        np.testing.assert_array_equal(out.numpy(), tab.numpy()[:, idx.numpy()])


def test_gather_checks_arguments():
    tab = torch.zeros((9, 64))
    with pytest.raises(ValueError, match="int32"):
        gp.gather_cols(tab, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        sp.smem_gather(tab.double(), torch.zeros(4, dtype=torch.int32))
    # the bench-scale bound: ids in, the table once, the output out
    assert bound_ms(0, gp.gather_bytes(9, 1 << 19, 1 << 21)) == (
        pytest.approx(0.0307, abs=1e-4), "bytes")


def test_smem_row_split():
    """The reference's (16, 4096) table is 256 KiB: two blocks of 8 rows
    (128 KiB each); a row that does not fit in a block raises."""
    assert sp.split_rows(16, 4096) == 8
    assert sp.split_rows(9, 4096) == 9
    assert sp.split_rows(4, 4096) == 4
    assert sp.split_rows(16, 1024) == 16
    assert 4 * sp.split_rows(16, 4096) * 4096 <= sp.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="exceeds"):
        sp.split_rows(16, 60_000)


@pytest.mark.parametrize("probe", PROBES)
def test_probes_need_a_card(probe, monkeypatch):
    """A probe measures a card: without one it exits nonzero, printing no
    result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main([])
    assert exc.value.code not in (0, None)


# -- the kernels (need a card) ------------------------------------------------------



@pytest.mark.parametrize("kernel", sorted(rv.VARIANTS))
def test_every_design_variant_applies(kernel):
    """Each edit of each design variant (K1, K2, K3, K4, K6 and K9) applies to
    the shipped source, its headers inlined; every variant but "shipped"
    changes it; a variant that is a source of its own (K4's three passes)
    has the shipped C entry points; an edit that does not apply raises."""
    shipped = rv.variant_source(kernel, [])
    assert "#include \"" not in shipped
    entries = set(re.findall(r'extern "C" int (\w+)\(', shipped))
    for name, edits in rv.VARIANTS[kernel].items():
        src = rv.variant_source(kernel, edits)
        assert (src == shipped) == (not edits), name
        if isinstance(edits, Path):
            assert {f"{kernel}_chunk", kernel} <= set(re.findall(r'extern "C" int (\w+)\(', src))
            assert {f"{kernel}_chunk", kernel} <= entries
    with pytest.raises(RuntimeError, match="no longer applies"):
        rv.variant_source(kernel, [("no such text", "")])

@pytest.mark.cuda
def test_peak_kernel_matches_plain(cuda_device):
    for form, kk in pp.REFERENCE_RUNS + (("fast_exp_ilp", 16), ("fma_ilp", 1024)):
        x = pp.probe_input((3, 1000), form, cuda_device)
        before = pp.peak_launches
        y = pp.peak(x, form, kk)
        torch.cuda.synchronize()
        assert pp.peak_launches == before + 1
        atol = 2e-2 if form.endswith("bf16") else 1e-5
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   pp.peak_reference(x, form, kk).float().cpu().numpy(),
                                   atol=atol, err_msg=form)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9, 16])
def test_gather_kernels_equal_plain(cuda_device, rows):
    """K7 and K6 (at 16 rows through its two-block row split) equal tab[:, ids]."""
    tab, ids, _ = gp.probe_inputs(cuda_device, rows, 4096, 8192, seed=2)
    ref = gp.gather_cols_reference(tab, ids)
    before = (gp.gather_cols_launches, sp.smem_gather_launches)
    assert torch.equal(gp.gather_cols(tab, ids), ref)
    assert torch.equal(sp.smem_gather(tab, ids), ref)
    assert torch.equal(sp.smem_gather(tab, ids.view(-1, 128)), ref.view(rows, -1, 128))
    torch.cuda.synchronize()
    assert (gp.gather_cols_launches, sp.smem_gather_launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 9, 16, 17])
@pytest.mark.parametrize("d", [8192, 8193, 8195])
def test_gather_cols_kernel_edges(cuda_device, rows, d):
    """K7 at the row-group edges (1 row; 9 = 8 + 1; 16 = 8 + 8; 17), d not
    a multiple of the block or of 4, ids starting off a 16-byte boundary
    (ids[1:]): equal to tab[:, ids]; indices outside [0, N) give NaN."""
    tab, ids, _ = gp.probe_inputs(cuda_device, rows, 4096, d + 1, seed=rows)
    for idx in (ids[:d], ids[1:]):
        assert torch.equal(gp.gather_cols(tab, idx), gp.gather_cols_reference(tab, idx))
    bad = ids[:d].clone()
    bad[::7] = 4096
    bad[3::11] = -1
    out = gp.gather_cols(tab, bad)
    oob = (bad < 0) | (bad >= 4096)
    assert torch.isnan(out[:, oob]).all()
    assert torch.equal(out[:, ~oob], gp.gather_cols_reference(tab, bad[~oob]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_block", [4, 8])
@pytest.mark.parametrize("d", [8192, 8193, 8195])
def test_smem_gather_kernel_edges(cuda_device, rows_per_block, d):
    """K6 at 4 and 8 rows a block, d % 4 in {0, 1, 3}, ids starting off a
    16-byte boundary (ids[1:], the one-id-a-thread path), tables of 4096
    and 4095 columns: equal to tab[:, ids]; indices outside [0, cols) give
    NaN."""
    for cols in (4096, 4095):
        tab, ids, _ = gp.probe_inputs(cuda_device, 16, cols, d + 1, seed=d)
        for idx in (ids[:d], ids[1:]):
            assert torch.equal(sp.smem_gather(tab, idx, rows_per_block),
                               sp.smem_gather_reference(tab, idx))
        bad = ids[:d].clone()
        bad[::7] = cols
        bad[3::11] = -1
        out = sp.smem_gather(tab, bad, rows_per_block)
        oob = (bad < 0) | (bad >= cols)
        assert torch.isnan(out[:, oob]).all()
        assert torch.equal(out[:, ~oob], sp.smem_gather_reference(tab, bad[~oob]))


def test_l2_sector_bytes_at_the_bench_scale():
    """32 B a (row, random index): 604 MB for 9 rows and 2^21 ids, six times
    the bound's DRAM bytes."""
    assert gp.l2_sector_bytes(9, 1 << 21) == 603_979_776
    assert gp.l2_sector_bytes(9, 1 << 21) / gp.gather_bytes(9, 1 << 19, 1 << 21) > 5.8


@pytest.mark.cuda
def test_smem_gather_refused_request_raises(cuda_device):
    """16 rows of 4096 in one block ask for 256 KiB: the card refuses, the
    wrapper raises, and a later launch still runs."""
    tab, ids, _ = gp.probe_inputs(cuda_device, 16, 4096, 1024, seed=2)
    with pytest.raises(RuntimeError, match="refused"):
        sp.smem_gather(tab, ids, rows_per_block=16)
    assert torch.equal(sp.smem_gather(tab, ids), gp.gather_cols_reference(tab, ids))
