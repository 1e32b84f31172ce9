"""The paper's decision framework in action, at three fidelities.

Default: compile one registry Scenario three ways — the analytical planner
(ranked plans), a virtual-clock engine replica (real scheduler/allocator
dynamics), and the full cluster runtime (open-loop arrivals, routing, SLOs)
— and report planner-predicted vs simulated decode throughput side by side:

    PYTHONPATH=src python -m repro_torch.examples.plan_deployment \
        --scenario ds8b-4xh200-colocated

Classic mode — rank parallelism plans for any assigned architecture:

    PYTHONPATH=src python -m repro_torch.examples.plan_deployment \
        --arch kimi-k2-1t-a32b --hw v5e --devices 256

The reference's ``examples/plan_deployment.py`` on the port's scenario
layer; ``--hw`` also takes ``h100``, the card the port runs on. Host only.
"""
import argparse
import sys

from repro_torch.configs.registry import ALL_MODELS, get_config
from repro_torch.core import planner
from repro_torch.scenario import HARDWARE, SCENARIOS, estimate_fleet, get_scenario


def print_plan_table(ests, k: int = 8):
    print(f"{'plan':>16s} {'est completion':>15s} {'decode tok/s':>13s} "
          f"{'conc/replica':>13s} {'KV cap (tok)':>13s}")
    for e in ests[:k]:
        if e.feasible:
            print(f"{e.label():>16s} {e.completion_s:>14.0f}s "
                  f"{e.decode_tput_tok_s:>13.0f} {e.concurrency:>13d} "
                  f"{e.kv_capacity_tokens:>13d}")
        else:
            print(f"{e.label():>16s}   INFEASIBLE ({e.reason})")


def rank_arch(args):
    cfg = get_config(args.arch)
    hw = HARDWARE[args.hw]
    wl = planner.Workload(mean_osl=args.mean_osl)
    ests = planner.plan(cfg, hw, args.devices, wl,
                        dtype_bytes=1 if args.fp8 else 2)
    print(f"{args.arch} on {args.devices}x {hw.name} "
          f"(mean OSL {args.mean_osl:.0f}):")
    print_plan_table(ests)


def three_fidelities(name: str):
    sc = get_scenario(name)
    diags = sc.check()
    if diags:
        for d in diags:
            print(f"preflight: {sc.name}: {d.format()}", file=sys.stderr)
        sys.exit(2)
    print(f"== scenario {sc.name}: {sc.model.name} on {sc.n_devices} devices,"
          f" {sc.traffic.process} traffic ==\n")

    # fidelity 1 — analytical planner over the scenario's device budget
    ests = sc.to_plan()
    print("[1/3] planner (analytic, ~ms):")
    print_plan_table(ests)
    if len(sc.fleet) == 1:
        chosen = estimate_fleet(sc)
        print(f"  scenario's own fleet = {chosen.label()}: "
              f"predicted decode {chosen.decode_tput_tok_s:.0f} tok/s\n")
    else:
        # a disaggregated fleet has no single aggregate plan; compare
        # against the best ranked colocated plan for the same budget
        chosen = next(e for e in ests if e.feasible)
        print(f"  best ranked plan = {chosen.label()}: "
              f"predicted decode {chosen.decode_tput_tok_s:.0f} tok/s "
              f"(disaggregated fleet benchmarked against it)\n")

    # fidelity 2 — one decode-capable virtual-clock replica, closed loop
    # (capacity measure; prefill-only groups can't decode the workload)
    gi = next(i for i, g in enumerate(sc.fleet) if g.role != "prefill")
    g = sc.fleet[gi]
    eng = sc.to_engine(group=gi)
    entries = sc.trace()
    share = entries[::g.count]            # this replica's round-robin share
    for e in share:
        eng.submit(e.isl, e.osl, arrival=0.0)
    s = eng.run(max_steps=2_000_000).summary()
    sim_fleet = s["gen_throughput_tok_s"] * g.count
    print(f"[2/3] engine sim (1 {g.role} replica, closed loop, "
          f"{len(share)} reqs): {s['gen_throughput_tok_s']:.0f} tok/s/replica "
          f"-> x{g.count} = {sim_fleet:.0f} tok/s fleet\n")

    # fidelity 3 — the full fleet under open-loop arrivals and SLOs
    rt = sc.to_cluster()
    rt.submit_trace(entries)
    m = rt.run()
    slo = sc.slo()
    cs = m.summary(slo)
    print(f"[3/3] cluster sim ({len(rt.workers)} workers, "
          f"{sc.traffic.process} arrivals): "
          f"{cs['throughput_tok_s']:.0f} tok/s delivered"
          + (f", goodput {cs['goodput_tok_s']:.0f} tok/s "
             f"(SLO attainment {cs['slo_attainment']:.2f})"
             if slo is not None else ""))

    print(f"\ndecode throughput, side by side (tok/s, fleet):")
    print(f"  planner predicted : {chosen.decode_tput_tok_s:>8.0f}  "
          "(steady-state capacity)")
    print(f"  engine simulated  : {sim_fleet:>8.0f}  "
          "(closed-loop, real batching/preemption)")
    print(f"  cluster simulated : {cs['throughput_tok_s']:>8.0f}  "
          "(open-loop arrivals — delivered, not capacity)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="ds8b-4xh200-colocated",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--arch", default=None, choices=sorted(ALL_MODELS),
                    help="classic mode: rank plans for an architecture")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="v5e")
    ap.add_argument("--devices", type=int, default=256)
    ap.add_argument("--mean-osl", type=float, default=6800.0)
    ap.add_argument("--fp8", action="store_true", help="fp8 weights")
    args = ap.parse_args()

    if args.arch:
        rank_arch(args)
    else:
        classic_flags_used = (args.hw != "v5e" or args.devices != 256
                              or args.mean_osl != 6800.0 or args.fp8)
        if classic_flags_used:
            ap.error("--hw/--devices/--mean-osl/--fp8 only apply to classic "
                     "mode; pass --arch as well (scenario mode takes these "
                     "from the spec)")
        three_fidelities(args.scenario)


if __name__ == "__main__":
    main()
