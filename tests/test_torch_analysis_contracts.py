"""repro_torch.analysis on the CPU: every contract clean, and the CLI.

Each registered contract runs on the CPU (the kernels' plain versions;
no-f64 on the meta device) and finds no violation. The CLI exits 0 on the
port (lint, kernel contracts, ``--device cpu`` contracts), 1 on a file
with a finding, and stops with an error that names ``--device cpu`` when
the card it defaults to is absent.
"""
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.analysis.__main__ import main


@pytest.fixture(autouse=True)
def _one_thread():
    """These checks run many small ops: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(contracts.CHECKS))
def test_contract_clean_on_the_cpu(name):
    assert contracts.run_contracts(only=[name], device="cpu") == []


def test_cli_kernels_and_lint_clean():
    assert main(["--kernels"]) == 0
    assert main(["--lint", "src/repro_torch"]) == 0


def test_cli_lint_finding_exits_1(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def decode_step(x):\n    return x.item()\n")
    assert main(["--lint", str(bad)]) == 1
    assert "FLD105" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("def decode_step(x):\n    return x\n")
    assert main(["--lint", str(good)]) == 0


def test_cli_contract_on_the_cpu(capsys):
    assert main(["--contract", "dw-zero-attn", "--device", "cpu"]) == 0
    assert "[contracts] 0 violation(s)" in capsys.readouterr().out


def test_cli_defaults_to_the_card_and_says_how_to_use_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--contract", "dw-zero-ffn"], ["--contracts"], []):
        with pytest.raises(RuntimeError, match="pass --device cpu"):
            main(argv)
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        contracts.run_contracts(only=["dw-zero-ffn"], device="cuda")
