"""The port's profiling and plotting helpers on the CPU
(``utils.profiling``, ``utils.plotting``): the timer's statistics, the
trace context's Chrome trace, the labelled wall timer, and the pulse
plot, whose amplitudes are those of the JAX package's envelope to 1e-12
(float64)."""
import json

import jax.numpy as jnp
import numpy as np
import torch

from diffquantum_tpu.pulses.envelope import SimpleEnvelope as JEnvelope
from diffquantum_tpu_torch.pulses.envelope import SimpleEnvelope
from diffquantum_tpu_torch.utils import plotting, profiling


def test_timed_and_wall_timer(capsys):
    calls = []
    out = profiling.timed(lambda x: calls.append(x) or torch.ones(3) * x, 2.0,
                          n_warmup=1, n_runs=4)
    assert len(calls) == 5 and out["n_runs"] == 4
    assert 0.0 <= out["p10_s"] <= out["median_s"] <= out["p90_s"]
    assert profiling._cuda_device((torch.ones(1), [torch.zeros(2)])) is None
    with profiling.wall_timer("block"):
        pass
    assert capsys.readouterr().out.startswith("[block] ")


def test_xla_trace_writes_a_chrome_trace(tmp_path):
    with profiling.xla_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert any("cumsum" in ev.get("name", "")
               for ev in trace["traceEvents"])


def test_save_pulse_plot(tmp_path):
    omegas = (np.pi, 2.0, 1.0)
    env = SimpleEnvelope(basis="bspline", n_basis=5, omegas=omegas)
    coeff = np.random.default_rng(1).standard_normal(env.coeff_shape)
    path = tmp_path / "pulses.png"
    assert plotting.save_pulse_plot(env, torch.tensor(coeff), 2.0, str(path),
                                    n_points=50)
    assert path.stat().st_size > 0
    # what it plots: the envelope on its grid, as the JAX package's
    ts = np.linspace(0.0, 2.0, 50, endpoint=False)
    got = env.amplitudes(torch.tensor(coeff), torch.tensor(ts), 2.0)
    want = JEnvelope(basis="bspline", n_basis=5, omegas=omegas).amplitudes(
        jnp.asarray(coeff), jnp.asarray(ts), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
