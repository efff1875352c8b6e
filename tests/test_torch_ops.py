"""``synth/device.py::synth_spectra`` of the port against the JAX package's,
and the port's spans in a ``torch.profiler`` Chrome trace on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import nvorbis_tpu_torch as nvt
from nvorbis_tpu.synth import device as j_dev
from nvorbis_tpu.synth.oracle import imdct_basis
from nvorbis_tpu_torch.synth import device as t_dev
from nvorbis_tpu_torch.testgen.vorbis_writer import make_simple_spec
from nvorbis_tpu_torch.utils import profiling


def _inputs(n, B=12, C=2, P=8, seed=0):
    """Coupled channels with six used posts (stream tables), a tenth of
    the channels without a floor, |pcm| about 1."""
    n2 = n // 2
    rng = np.random.default_rng(seed)
    xs = np.full((C, P), int(t_dev._XS_PAD), dtype=np.int32)
    xs[:, :6] = [0, n2 // 16, n2 // 8, n2 // 4, n2 * 11 // 16, n2]
    residue = (rng.standard_normal((B, C, n2))
               * np.sqrt(4.0 / n)).astype(np.float32)
    ys = rng.integers(0, 256, size=(B, C, P)).astype(np.int32)
    used = np.broadcast_to(xs < t_dev._XS_PAD, (B, C, P)).copy()
    has_floor = rng.random((B, C)) < 0.9
    return residue, ys, used, has_floor, xs


@pytest.mark.parametrize("n", [256, 2048])
def test_synth_spectra_matches_jax(n):
    """The un-windowed synthesis (the kernel's twin with a window of ones)
    within 2e-6 of the JAX package's ``synth_spectra``, with the static
    bin map and without it."""
    import jax.numpy as jnp

    residue, ys, used, has_floor, xs = _inputs(n)
    basis = imdct_basis(n, np.float32)
    sl = t_dev.floor1_bin_map(xs, n // 2)
    for with_sl in (True, False):
        want = np.asarray(j_dev.synth_spectra(
            jnp.asarray(residue), jnp.asarray(ys), jnp.asarray(used),
            jnp.asarray(has_floor), jnp.asarray(xs), jnp.asarray(basis),
            ((0, 1),), sl=jnp.asarray(sl) if with_sl else None))
        got = t_dev.synth_spectra(
            *(torch.as_tensor(a) for a in (residue, ys, used, has_floor,
                                           xs)),
            None, ((0, 1),), torch.as_tensor(sl) if with_sl else None)
        assert got.shape == want.shape == (residue.shape[0], 2, n)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_synth_spectra_is_synth_core_over_a_window_of_ones():
    """Through ``synth_core`` with one window of ones the same rows come
    out bit for bit: ``synth_spectra`` is the kernel's path, unwindowed."""
    n = 256
    residue, ys, used, has_floor, xs = (torch.as_tensor(a)
                                        for a in _inputs(n, seed=3))
    sl = torch.as_tensor(t_dev.floor1_bin_map(xs.numpy(), n // 2))
    idb = t_dev.inverse_db_table("cpu")
    got = t_dev.synth_spectra(residue, ys, used, has_floor, xs, None,
                              ((0, 1),), sl, idb)
    want = t_dev.synth_core(residue, ys, used, has_floor,
                            torch.zeros(residue.shape[0], dtype=torch.int32),
                            xs, torch.ones((1, n)), None, ((0, 1),), sl, idb)
    assert torch.equal(got, want)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A ``torch.profiler`` trace of a ``read_all`` taken while tracing is
    enabled, written as TensorBoard's Chrome trace, holds the device
    stages' spans (``nvt.*``) and the program's host spans
    (``bulk.upload``) beside them."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    blob = make_simple_spec(channels=2, residue_type=2).build_stream(
        np.random.default_rng(5), 60)
    logdir = tmp_path / "trace"
    profiling.enable(True)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     on_trace_ready=tensorboard_trace_handler(str(logdir))):
            nvt.VorbisReader(blob, device="cpu").read_all()
    finally:
        profiling.enable(False)
        profiling.reset()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(logdir / files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("nvt.") for n in names)
    assert "bulk.upload" in names
