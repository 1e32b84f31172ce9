"""Faults planted underneath the timed path, to show that the comparison
catches them: the benchmark's own tests plant them at smoke size, and
``bench/run.py --fault <name>`` (which no run of the benchmark passes)
reads them at a cell's own size. Each replaces a method or function of
the program in this process only; the program's files are untouched.

  * ``token_altered``: a token altered where it is produced, every fifth
    row's of each decode step and every prefill's first token;
  * ``state_unchanged``: a decode step that leaves the cache as it was
    (no new k and v written);
  * ``half_batch``: half of the batch left out, its rows given the other
    half's tokens.

A cell on one chip has no exchange between chips to leave out."""
from __future__ import annotations

FAULTS = ("token_altered", "state_unchanged", "half_batch")


def plant(fault: str, setattr=setattr):
    """Plant ``fault`` (``setattr`` may be pytest's ``monkeypatch.setattr``,
    which undoes it after the test)."""
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models import transformer

    decode, prefill = TorchRunner.decode, TorchRunner.prefill
    if fault == "token_altered":
        def bad_decode(self, reqs):
            return [(t + 1) % self.model.cfg.vocab if i % 5 == 2 else t
                    for i, t in enumerate(decode(self, reqs))]

        def bad_prefill(self, req, chunk):
            return (prefill(self, req, chunk) + 1) % self.model.cfg.vocab
        setattr(TorchRunner, "decode", bad_decode)
        setattr(TorchRunner, "prefill", bad_prefill)
    elif fault == "state_unchanged":
        setattr(transformer, "_put", lambda *a, **k: None)
    elif fault == "half_batch":
        def bad_decode(self, reqs):
            if len(reqs) < 2:
                return decode(self, reqs)
            half = decode(self, reqs[:(len(reqs) + 1) // 2])
            return half + half[:len(reqs) - len(half)]
        setattr(TorchRunner, "decode", bad_decode)
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")
