"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the timed path
finished, drawn from the seed and always holding the one with the most
served tokens, is run through the plain reference: each prompt with its
served tokens, from position 0, in fp32. At every served token the gap
is the reference's best logit at that position less the reference's
logit of the served token (0 where the served token is the reference's
first choice). A cell compares the widest gap over the sample, or the
mean gap, or both, with its limits. The control puts the reference in
fp8 in the program's place: at the same positions the gap of the token
that fp8 puts first, judged by the same numbers and limits in place of
the program's, so that a control run reports ``correct`` false."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def sample(finished: List, seed: int, budget: int) -> List:
    """The longest (most served tokens) and then others in the seed's
    order, while the reference's tokens (prompt and served tokens) stay
    within ``budget``."""
    if not finished:
        return []
    finished = sorted(finished, key=lambda r: r.rid)
    longest = max(finished, key=lambda r: (len(r.output), -r.rid))
    rest = [r for r in finished if r is not longest]
    rest = [rest[i] for i in np.random.default_rng([seed, 4]).permutation(len(rest))]
    out, used = [longest], ref_tokens(longest)
    for r in rest:
        if used + ref_tokens(r) <= budget:
            out.append(r)
            used += ref_tokens(r)
    return out


def ref_tokens(r) -> int:
    return len(r.prompt) + len(r.output) - 1


@torch.no_grad()
def gaps(decoder, requests: List, device, control=None) -> Dict[int, Dict]:
    """Each request's gaps at its served tokens, and with ``control`` (the
    fp8 decoder) the gaps of the control's first choices. Every request
    goes through the reference at once, layer by layer."""
    seqs = [(torch.tensor(r.prompt + r.output[:-1], dtype=torch.long, device=device),
             len(r.prompt) - 1) for r in requests]
    if not seqs:
        return {}
    ref_h = decoder.hidden(seqs)
    ctl_h = control.hidden(seqs) if control is not None else None
    head = decoder.head()
    ctl_head = control.head() if control is not None else None
    out = {}
    for i, r in enumerate(requests):
        ref = decoder.mm(ref_h[i], head)
        best = ref.max(-1).values
        served = torch.tensor(r.output, dtype=torch.long, device=device)
        row = {"gaps": (best - ref.gather(1, served[:, None])[:, 0]).cpu().tolist()}
        if control is not None:
            pick = control.mm(ctl_h[i], ctl_head).argmax(-1)
            row["control_gaps"] = (best - ref.gather(1, pick[:, None])[:, 0]).cpu().tolist()
        out[r.rid] = row
    return out


NUMBERS = ("logit_gap", "mean_logit_gap")


def numbers(rows: Dict[int, Dict], key: str = "gaps") -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap over every served
    token of the sample, and the mean gap."""
    every = [g for v in rows.values() for g in v.get(key, [])]
    if not every:
        return {}
    return {"logit_gap": max(every), "mean_logit_gap": sum(every) / len(every)}


def verdict(rows: Dict[int, Dict], check: Dict, refused: int, key: str = "gaps") -> Dict:
    """``correct``, ``failed`` and the numbers compared, each with its
    limit (``<number>_limit`` in the cell's ``check``), of the gaps under
    ``key``: the program's, or with ``control_gaps`` the control's."""
    got = numbers(rows, key)
    limits = {k[:-len("_limit")]: float(v) for k, v in check.items()
              if k.endswith("_limit") and k[:-len("_limit")] in NUMBERS}
    n = sum(len(v[key]) for v in rows.values())
    checks = {k: {"value": got.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}
    checks["served_tokens_compared"] = {"value": n, "limit": int(check["min_served_tokens"])}
    checks["requests_refused"] = {"value": refused, "limit": 0}
    # a request fails by its own widest gap (the mean is the sample's)
    wide = limits.get("logit_gap")
    wrong = 0 if wide is None else sum(max(v[key]) > wide for v in rows.values())
    ok = (bool(rows) and all(checks[k]["value"] <= lim for k, lim in limits.items())
          and n >= int(check["min_served_tokens"]) and not refused)
    return {"correct": ok, "failed": wrong + refused, "checks": checks}
