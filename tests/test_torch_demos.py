"""Each script of ``demos_torch/`` (the port's counterparts of ``demos/``)
run in-process through its ``main(argv)`` on the CPU at its smallest
settings, holding the line it prints. The recipes are the JAX demos';
these runs check that each script drives the port end to end, not that
a cut run converges."""
import importlib.util
import pathlib
import re

import pytest

DEMOS = pathlib.Path(__file__).resolve().parents[1] / "demos_torch"

# script -> (argv, a regular expression its output must match)
CASES = {
    "maxcut": (["--epochs", "3"],
               r"cut result is [01]{4}\ncut value: \d\.0 / max cut: 4\.0"),
    "maxcut_seeds": (["--qubits", "4", "--seeds", "2", "--epochs", "2"],
                     r"2 seeds x 2 epochs x 4 qubits in .*\nbest seed: #\d, "
                     r"optimality gap \d+\.\d{4}"),
    "vqe_h2": (["--epochs", "3"],
               r"final energy: +-?\d+\.\d{6} Ha\nexact ground: +-1\.\d{6} Ha"
               r"\nerror: +\d+\.\d{3} mHa"),
    "control": (["--task", "transfer", "--epochs", "3"],
                r"task: transfer\nfinal mean infidelity: .*\(fidelity "
                r"0\.\d{6}\)\n  pair 0: fidelity 0\.\d{6}"),
    "tfim": (["--n", "4", "--epochs", "2"],
             r"TFIM chain: n=4, .*\nfinal energy: +-\d\.\d{6}\n"
             r"free-fermion ground: +-\d\.\d{6}\ngap: \d\.\d{6}"),
    "h2_dissociation": (["--points", "1", "--epochs", "2"],
                        r" +0\.400 +-?\d+\.\d{6} +-?\d+\.\d{6} +-?\d+\.\d{3}"
                        r" +-?\d+\.\d{6}\n\nworst \|error\|: \d+\.\d{3} mHa"),
    "hydrogen_chain": (["--atoms", "2", "--epochs", "2", "--seeds", "2"],
                       r"H2 chain, R = 0\.9 A: \d+ Pauli terms, \d+ drives\n"
                       r"RHF: -1\.\d{6} Ha   FCI: -1\.\d{6} Ha.*\n"
                       r"pulse VQE \(best of 2\): -?\d+\.\d{6} Ha"),
    "channel_control": (["--epochs", "2", "--seeds", "1", "--per-step",
                         "20"],
                        r"epoch: 0002, best infidelity: 0\.\d{6}.*\n"
                        r"best Bell fidelity: 0\.\d{6} \(1 seeds, "
                        r"channel/carrier pulse model\)"),
    "open_control": (["--epochs", "2", "--n-traj", "20", "--mcwf-epochs",
                      "1"],
                     r"noise-blind pulse, open-system fidelity: +0\.\d{4}\n"
                     r"noise-aware pulse, open-system fidelity: +0\.\d{4}\n"
                     r"advantage: [+-]0\.\d{4}\nMCWF check \(20 "
                     r"trajectories\): fidelity [01]\.\d{4}"),
}


def load_demo(name: str):
    """demos_torch/demo_<name>.py as a module (the directory is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"demos_torch_{name}", DEMOS / f"demo_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_demo_has_a_port():
    jax_demos = {p.name for p in (DEMOS.parent / "demos").glob("demo_*.py")}
    assert jax_demos == {p.name for p in DEMOS.glob("demo_*.py")}
    assert {f"demo_{n}.py" for n in CASES} == jax_demos


@pytest.mark.parametrize("name", sorted(CASES))
def test_demo_runs_on_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)   # the loggers write under ./logs
    argv, pattern = CASES[name]
    out = load_demo(name).main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert re.search(pattern, text), text[-2000:]
    assert out is not None


def test_demos_default_to_the_card(monkeypatch):
    """Without a card each script raises unless asked for the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_demo("vqe_h2").main(["--epochs", "1"])
