"""Integration/regression tests for the public Speedy API, mirroring the
reference test strategy (pyspeedy/tests/test_speedy.py):

* golden-run regression with a tolerance ladder against this repo's own
  fixtures (tight, rtol down to 1e-6);
* comparison against the *reference repository's* fixtures at the accuracy
  floor set by its missing sst_anomaly.nc input data (the residual matches
  the measured day-1 sensitivity to ~0.5 K SST anomalies — see README);
* state-isolation (two interleaved instances), ensemble-vs-deterministic
  equivalence, failure paths, and variable-export naming.
"""

import math
import os
import tempfile
from datetime import datetime, timedelta

import numpy as np
import pytest

import pyspeedy_tpu  # noqa: F401  (triggers jax config via conftest)
from pyspeedy_tpu.callbacks import XarrayExporter
from pyspeedy_tpu.speedy import Speedy, SpeedyEns
from pyspeedy_tpu.utils.dataset import open_dataset

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
# The reference repository's own fixtures, where a checkout of it is at hand:
# PYSPEEDY_REFERENCE_FIXTURES=<pySPEEDY checkout>/pyspeedy/tests/fixtures
REF_FIXTURE_DIR = os.environ.get("PYSPEEDY_REFERENCE_FIXTURES", "")

start_dates = (
    # Run the same date twice to catch any leaked global state.
    (datetime(1982, 1, 1), datetime(1982, 1, 2)),
    (datetime(1982, 1, 1), datetime(1982, 1, 2)),
    (datetime(1982, 1, 1), datetime(1982, 1, 4)),
)

export_variables = (
    ["u_grid", "v_grid"],
    ["t_grid", "q_grid"],
    ["phi_grid", "ps_grid"],
    ["precnv", "precls"],
)


def assert_ds_allclose(a, b, rtol, atol=0.0):
    for v in b.keys():
        x = np.asarray(a[v].data, dtype=np.float64)
        y = np.asarray(b[v].data, dtype=np.float64)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                   err_msg=f"variable {v}")


@pytest.mark.parametrize("start_date, end_date", start_dates)
def test_speedy_run(start_date, end_date):
    """Golden-run regression against this repo's fixtures with the
    reference's tolerance-ladder pattern."""
    file_name = end_date.strftime("%Y-%m-%d_%H%M.nc")
    reference_ds = open_dataset(os.path.join(FIXTURE_DIR, file_name))

    with tempfile.TemporaryDirectory() as tmp_work_dir:
        model = Speedy(start_date=start_date, end_date=end_date)
        model.set_bc()
        model.run(callbacks=[XarrayExporter(output_dir=tmp_work_dir)])

        model_ds = open_dataset(os.path.join(tmp_work_dir, file_name))
        for rtol in (1e-1, 1e-2, 1e-3, 1e-4, 1e-6):
            assert_ds_allclose(model_ds, reference_ds, rtol=rtol)


@pytest.mark.parametrize("day, file_name",
                         [(1, "1982-01-02_0000.nc"), (3, "1982-01-04_0000.nc")])
def test_against_reference_repo_fixtures(day, file_name):
    """Track the reference repository's own golden fixtures. The residual is
    bounded by the reference's missing SST-anomaly input data (zero anomalies
    are used here); this pins the achievable agreement so regressions that
    push beyond the SST floor are caught."""
    if not os.path.isdir(REF_FIXTURE_DIR):
        pytest.skip("reference repository fixtures not available (set "
                    "PYSPEEDY_REFERENCE_FIXTURES to their directory)")
    ref = open_dataset(os.path.join(REF_FIXTURE_DIR, file_name))
    mine = open_dataset(os.path.join(FIXTURE_DIR, file_name))
    # Per-day limits at ~1.4x the measured SSTA-floor residual (day 1:
    # u 0.0129, v 0.0157; day 3: u 0.0223, v 0.0281 — zero anomalies vs the
    # reference's missing anomaly dataset), so a dynamics regression that
    # pushes past the floor fails instead of hiding under a shared bound.
    limits_by_day = {
        1: {"u": 0.018, "v": 0.022, "t": 6.5e-4, "q": 8e-3,
            "phi": 1.6e-4, "ps": 5.5e-4},
        3: {"u": 0.032, "v": 0.040, "t": 9.5e-4, "q": 8e-3,
            "phi": 2.3e-4, "ps": 8.5e-4},
    }
    for v, lim in limits_by_day[day].items():
        a = np.asarray(mine[v].data, np.float64).squeeze()
        b = np.asarray(ref[v].data, np.float64).squeeze()
        scale = np.abs(b).max()
        rms = math.sqrt(float(((a - b) ** 2).mean())) / scale
        assert rms < lim, f"{v}: rms/scale {rms:.2e} exceeds {lim}"


def test_speedy_concurrent():
    """Two interleaved instances must both match the golden run — the vmap/
    pytree analog of the reference's thread-safety test."""
    start_date = datetime(1982, 1, 1)
    end_date = datetime(1982, 1, 4)
    ndays = 3
    file_name = end_date.strftime("%Y-%m-%d_%H%M.nc")
    reference_ds = open_dataset(os.path.join(FIXTURE_DIR, file_name))

    with tempfile.TemporaryDirectory() as tmp_work_dir:
        d1 = os.path.join(tmp_work_dir, "run1")
        d2 = os.path.join(tmp_work_dir, "run2")

        model = Speedy(start_date=start_date, end_date=end_date)
        model.set_bc()
        model2 = Speedy(start_date=start_date, end_date=end_date)
        model2.set_bc()

        for day in range(ndays):
            model.start_date = start_date + timedelta(days=day)
            model.end_date = start_date + timedelta(days=day + 1)
            model.run(callbacks=[XarrayExporter(output_dir=d1)])

            model2.start_date = start_date + timedelta(days=day)
            model2.end_date = start_date + timedelta(days=day + 1)
            model2.run(callbacks=[XarrayExporter(output_dir=d2)])

        for d in (d1, d2):
            model_ds = open_dataset(os.path.join(d, file_name))
            assert_ds_allclose(model_ds, reference_ds, rtol=1e-6)


def test_ens_speedy():
    """Unperturbed ensemble members must reproduce the deterministic run."""
    num_of_members = 3
    start_date = datetime(1982, 1, 1)
    end_date = datetime(1982, 1, 2)
    file_name = end_date.strftime("%Y-%m-%d_%H%M.nc")
    reference_ds = open_dataset(os.path.join(FIXTURE_DIR, file_name))

    model_ens = SpeedyEns(num_of_members, start_date=start_date,
                          end_date=end_date)
    for member in model_ens:
        member.set_bc()
    with tempfile.TemporaryDirectory() as tmp_work_dir:
        model_ens.run(callbacks=[XarrayExporter(output_dir=tmp_work_dir)])

        for m, member in enumerate(model_ens):
            member_df = member.to_dataframe().squeeze(dim="ens", drop=True)
            assert_ds_allclose(member_df, reference_ds, rtol=1e-6)
        # XarrayExporter writes each member under a member### subdirectory
        # (the reference's documented contract, callbacks.py:190-192).
        for m in range(num_of_members):
            member_path = os.path.join(tmp_work_dir, f"member{m:03d}",
                                       file_name)
            assert os.path.exists(member_path), member_path
            member_ds = open_dataset(member_path).squeeze(dim="ens",
                                                          drop=True)
            assert_ds_allclose(member_ds, reference_ds, rtol=1e-6)


def test_exceptions():
    """Zeroing spectral T must trip the diagnostics check."""
    model = Speedy(start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2))
    model.set_bc()
    model.run()

    t = model["t"]
    t[:] = 0
    model["t"] = t
    with pytest.raises(RuntimeError):
        model.check()


@pytest.mark.parametrize("variables", export_variables)
def test_speedy_variable_export(variables):
    """Exported variable names strip the _grid suffix via alt_name."""
    start_date = datetime(1982, 1, 1)
    end_date = datetime(1982, 1, 2)
    file_name = end_date.strftime("%Y-%m-%d_%H%M.nc")

    with tempfile.TemporaryDirectory() as tmp_work_dir:
        model = Speedy(start_date=start_date, end_date=end_date)
        model.set_bc()
        exporter = XarrayExporter(output_dir=tmp_work_dir,
                                  variables=variables)
        model.run(callbacks=[exporter])

        model_ds = open_dataset(os.path.join(tmp_work_dir, file_name))
        assert set(v.replace("_grid", "") for v in variables) == \
            set(model_ds.keys())


def test_state_get_set_roundtrip():
    """Dict-style state access round-trips through the Fortran-order API
    layout (pyspeedy/speedy.py:125-167 semantics)."""
    model = Speedy(start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2))
    model.set_bc()
    for name in ("vor", "t_grid", "ps_grid", "stl12", "slru", "rad_tau2"):
        arr = model[name]
        assert arr.shape == model.get_shape(name), name
        model[name] = arr
        np.testing.assert_array_equal(model[name], arr, err_msg=name)

    with pytest.raises(ValueError):
        model["t_grid"] = np.zeros((1, 2, 3))
    with pytest.raises(AttributeError):
        model["not_a_var"]


def test_checkpoint_roundtrip(tmp_path):
    """save_checkpoint/load_checkpoint restores the trajectory bitwise."""
    model = Speedy(start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 3))
    model.set_bc()
    model._advance(18)
    ckpt = str(tmp_path / "state.npz")
    model.save_checkpoint(ckpt)
    model._advance(18)
    ref_t = model["t_grid"].copy()

    model2 = Speedy(start_date=datetime(1982, 1, 1),
                    end_date=datetime(1982, 1, 3))
    model2.set_bc()
    model2.load_checkpoint(ckpt)
    assert model2.get_current_step() == 18
    model2._advance(18)
    np.testing.assert_array_equal(model2["t_grid"], ref_t)


def test_apply_grid_filter():
    model = Speedy(start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2))
    model.set_bc()
    model.spectral2grid()
    before = model["t_grid"].copy()
    model.apply_grid_filter()
    after = model["t_grid"]
    # The reference's transforms are non-orthogonal (node/weight quirk, see
    # ops/geometry.py), so even an already-truncated field changes by up to
    # ~2% near the poles — but not more, and the bulk of the field is intact.
    scale = np.abs(before).max()
    diff = np.abs(after - before)
    assert diff.max() / scale < 0.05
    assert np.sqrt((diff**2).mean()) / scale < 0.005


def test_ens_batched_equals_sequential():
    """SpeedyEns batched (vmapped) stepping must equal per-member stepping."""
    sd, ed = datetime(1982, 1, 1), datetime(1982, 1, 2)
    ens_a = SpeedyEns(2, start_date=sd, end_date=ed)
    ens_b = SpeedyEns(2, start_date=sd, end_date=ed)
    for m in ens_a:
        m.set_bc()
    for m in ens_b:
        m.set_bc()
    # perturb member 1 identically in both
    for ens in (ens_a, ens_b):
        m1 = ens.members[1]
        t = m1["t_grid"]
        m1["t_grid"] = t * (1.0 + 1e-5)
        m1.grid2spectral()
    ens_a.run(batched=True)
    ens_b.run(batched=False)
    for m in range(2):
        np.testing.assert_allclose(
            ens_a.members[m]["t_grid"], ens_b.members[m]["t_grid"],
            rtol=0, atol=1e-11, err_msg=f"member {m}")
    # Per-step physics diagnostics (EPHEMERAL_FIELDS) must be CURRENT after a
    # batched run, not initialization-time values: the reference's
    # parallel_step leaves every member's precnv/fluxes/... readable
    # (physics.f90:123-226). The batched runner returns the final step's
    # values for every member.
    from pyspeedy_tpu.physics.driver import DIAG_FIELDS
    for name in DIAG_FIELDS:
        for m in range(2):
            a, b = ens_a.members[m][name], ens_b.members[m][name]
            close = np.isclose(a, b, rtol=0, atol=1e-11)
            # Longwave-family diagnostics pass through the integer-temperature
            # fband lookup (longwave_radiation.f90:87): a ~1e-13 difference in
            # T between the vmapped and single programs can flip the rounding
            # at points sitting on a .5 K boundary, moving the flux by
            # ~1 W/m^2 at isolated points. Allow those rare flips only.
            frac = 1.0 - close.mean()
            assert frac < 2e-3, f"{name} member {m}: {frac:.2%} mismatched"
            assert np.abs(a - b).max() < 5.0, f"{name} member {m}"
    assert np.abs(ens_a.members[0]["precnv"]).max() > 0, \
        "diagnostics look like initialization-time zeros"
    # sanity: members actually diverged from each other
    assert np.abs(ens_a.members[0]["t_grid"]
                  - ens_a.members[1]["t_grid"]).max() > 1e-6


def test_sppt_ensemble_members_distinct():
    """SPPT ensembles: members carry distinct keyed RNG streams, so
    unperturbed members diverge through stochastic physics alone."""
    import dataclasses
    from pyspeedy_tpu.params import T30L8

    params = dataclasses.replace(T30L8, sppt_on=True)
    ens = SpeedyEns(2, start_date=datetime(1982, 1, 1),
                    end_date=datetime(1982, 1, 2), params=params)
    for m in ens:
        m.set_bc()
    ens.run()
    for m in ens:
        m.spectral2grid()
    d = np.abs(ens.members[0]["t_grid"] - ens.members[1]["t_grid"]).max()
    assert d > 1e-8, "SPPT members did not diverge"


def test_all_registry_variables_accessible():
    """Every registry variable must be readable with the reference's
    Fortran-order shape via dict access (the full bridge surface of
    speedy_driver.f90's get_*/get_*_shape)."""
    from pyspeedy_tpu.registry import MODEL_STATE_VARS

    model = Speedy(start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2))
    model.set_bc()
    for spec in MODEL_STATE_VARS:
        arr = model[spec.name]
        if spec.dims:
            assert np.asarray(arr).shape == model.get_shape(spec.name), \
                spec.name


def test_ens_batched_physics_off():
    """Batched ensemble stepping with physics disabled: EPHEMERAL fields pass
    through the runner at single-member shapes and must NOT be sliced on a
    non-member axis during unpack (round-3 advisor finding: hfluxn, which the
    coupler reads, was corrupted to a wrong-shaped array)."""
    import dataclasses

    sd, ed = datetime(1982, 1, 1), datetime(1982, 1, 2)
    ens_a = SpeedyEns(2, start_date=sd, end_date=ed)
    ens_b = SpeedyEns(2, start_date=sd, end_date=ed)
    for ens in (ens_a, ens_b):
        for m in ens:
            m.set_bc()
        off = dataclasses.replace(ens.members[0]._consts, physics_on=False)
        for m in ens:
            m._consts = off
        m1 = ens.members[1]
        m1["t_grid"] = m1["t_grid"] * (1.0 + 1e-5)
        m1.grid2spectral()
    shapes = {k: np.shape(v) for k, v in ens_a.members[0]._state.items()
              if not isinstance(v, tuple)}
    ens_a.run(batched=True)
    ens_b.run(batched=False)
    for m in range(2):
        np.testing.assert_allclose(
            ens_a.members[m]["t_grid"], ens_b.members[m]["t_grid"],
            rtol=0, atol=1e-11, err_msg=f"member {m}")
        # every non-batched state array keeps its allocation-time shape
        for k, shp in shapes.items():
            got = np.shape(ens_a.members[m]._state[k])
            assert got == shp, f"{k}: {got} != {shp}"
