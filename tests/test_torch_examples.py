"""The port's examples (``examples_torch/``) on the CPU at small sizes:
each ``main`` runs end to end, returns what it prints, and defaults to
the card. Their paper-level claims are held at full size by
``chip_smoke.py`` (the quickstart) and the card tests."""
import importlib.util
import inspect
import math
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "custom_mechanism", "dvfs_granularity",
            "ivr_regime", "serve_batched", "train_lm")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    """``device`` defaults to ``"cuda"``, which raises on a machine
    without a card instead of running on the CPU."""
    import torch
    main = _example(name).main
    assert inspect.signature(main).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "train_lm":
            main("/nonexistent", steps=1)
        else:
            main()


def test_quickstart(capsys):
    res = _example("quickstart").main(device="cpu", n_epochs=60)
    assert list(res) == ["static17", "crisp", "pcstall", "oracle"]
    assert all(math.isfinite(r["ednp_norm"]) for r in res.values())
    assert res["static17"]["ednp_norm"] == 1.0
    out = capsys.readouterr().out
    assert f"{res['pcstall']['ednp_norm']:>15.3f}" in out


def test_custom_mechanism_registers_and_leaves_the_registry(capsys):
    from repro_torch.core import mechanisms as MECH
    before = MECH.names()
    res = _example("custom_mechanism").main(
        device="cpu", n_epochs=40, workloads=("comd", "hacc"), n_cu=8)
    assert MECH.names() == before
    assert sorted(res) == [(o, w) for o in ("ed2p", "edp")
                           for w in ("comd", "hacc")]
    for row in res.values():
        assert "DSO (static+dynamic blend)" in row
        assert all(math.isfinite(x) and x > 0 for x in row.values())
    assert capsys.readouterr().out.count("ED^") == 4


def test_dvfs_granularity():
    res = _example("dvfs_granularity").main(device="cpu", n_epochs=40,
                                            domains=(1, 4), n_cu=8)
    assert sorted(res) == [(g, T, o) for g in (1, 4) for T in (1.0, 10.0)
                           for o in ("ed2p", "edp")]
    assert all(math.isfinite(v) for r in res.values() for v in r.values())


def test_ivr_regime():
    mod = _example("ivr_regime")
    res = mod.main(device="cpu", n_epochs=40, workloads=("comd", "hacc"),
                   n_cu=8)
    assert list(res) == list(mod.REGIMES)
    # the slower the regulator, the more the dead time costs
    assert res["400ns"]["pcstall"] > res["  4ns"]["pcstall"]


def test_serve_batched():
    rep = _example("serve_batched").main(device="cpu", batch=2,
                                         prompt_len=32, gen=4, dvfs=False)
    assert rep["tokens"].shape == (2, 5)
    assert rep["prefill_s"] > 0 and rep["decode_s_per_tok"] > 0


def test_train_lm_checkpoints_and_resumes(tmp_path):
    mod = _example("train_lm")
    losses = mod.main(str(tmp_path), device="cpu", steps=4, seq_len=32,
                      batch=4, checkpoint_every=2)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == ["step_00000002",
                                                     "step_00000003"]
