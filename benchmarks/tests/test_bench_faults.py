"""A run with its timed path broken underneath must come out not correct:
for each fault a cell can have, the harness is driven as a run drives it
(on the CPU, at a small size, past its look for a card) and ``correct``
read. One chip, so no cell can lose an exchange between chips."""

import pytest

from benchmarks.tests import tiny_cells

TRAIN = "train-gpt2-xl-t1024"
SERVE = ["serve-gpt2-medium-bulk", "serve-gpt2-xl-code"]


def test_sound_runs_are_correct():
    for name in [TRAIN] + SERVE:
        line = tiny_cells.run(tiny_cells.cell(name))
        assert line["correct"], (name, line["check"])


def test_open_loop_runs_are_correct():
    # the open loop (arrivals with due times, as the Poisson mix has) serves
    # every request due in the window, and the served tokens check correct
    c = tiny_cells.cell("serve-gpt2-xl-code", traffic="poisson-code-700")
    line = tiny_cells.run(c)
    assert line["correct"] and line["attempted"] > 0, line
    assert line["failed"] == 0, line


def _train_fault(monkeypatch, kind):
    from deeplearning4j_tpu_torch.models import transformer as T

    if kind == "state_unchanged":
        monkeypatch.setattr(T.AdamW, "update_", lambda *a, **k: None)
        return
    real = T.transformer_loss

    def broken(cfg, mesh=None):
        loss = real(cfg, mesh)
        if kind == "half_batch":
            return lambda p, tok: loss(p, tok[: tok.shape[0] // 2])
        return lambda p, tok: loss(p, tok) * 1.01  # the loss altered

    monkeypatch.setattr(T, "transformer_loss", broken)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "loss_altered"])
def test_train_fault_is_not_correct(monkeypatch, kind):
    _train_fault(monkeypatch, kind)
    line = tiny_cells.run(tiny_cells.cell(TRAIN))
    assert not line["correct"], line["check"]


def _serve_fault(monkeypatch, kind):
    from deeplearning4j_tpu_torch.models.transformer import kv_map
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    real = ServingEngine._run_step

    def broken(self, k):
        # the slots that decode in this horizon, whichever they are
        live = self._dactive.nonzero().flatten()
        if kind == "state_unchanged":
            cache = self.pool.operand()
            snap = kv_map(lambda c: c.clone(), cache)
            toks = real(self, k)
            kv_map(lambda c, s: c.copy_(s), cache, snap)
            return toks
        toks = real(self, k).clone()
        if kind == "half_batch":
            toks[live[1::2]] = 0
        else:  # a token altered where it is produced
            toks[:, 0] = (toks[:, 0] + 1) % self.cfg.vocab_size
        return toks

    monkeypatch.setattr(ServingEngine, "_run_step", broken)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "token_altered"])
def test_serve_fault_is_not_correct(monkeypatch, name, kind):
    _serve_fault(monkeypatch, kind)
    line = tiny_cells.run(tiny_cells.cell(name))
    assert not line["correct"], line["check"]
