"""Cluster serving demo: one scenario pair, two fleet shapes, plus tiers.

Replays the registry's `ds8b-4xh200-colocated` / `ds8b-4xh200-disagg`
scenarios — identical model, devices, traffic and SLO; only the fleet shape
differs — and prints the SLO-goodput comparison plus each replica's
KV-saturation trajectory, then runs the `ds8b-4xh200-mixed` multi-tenant
scenario and prints the per-class (interactive vs batch) breakdown, and
finally the `ds8b-autoscale-diurnal` elastic scenario with its scaling
timeline (replica joins/retires with timestamps). Fleets are built
exclusively by ``Scenario.to_cluster()``; goodput uses the corrected
accounting (fleet-makespan denominator, unfinished-as-miss).

The colocated/disagg pair also runs under a ``repro_torch.obs`` tap (a pure
event-stream subscriber — docs/obs.md): each fleet's summary line carries
the bottleneck-regime attribution, and the full report is a
``--report`` flag away.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--report]

The reference's ``examples/serve_cluster.py`` on the port's scenario and
obs layers. Host only: every worker is a virtual-clock ``SimRunner``.
"""
import dataclasses
import sys

from repro_torch.obs import attach, regime_fractions, render_text
from repro_torch.scenario import get_scenario

PAIR = ("ds8b-4xh200-colocated", "ds8b-4xh200-disagg")
MIXED = "ds8b-4xh200-mixed"
ELASTIC = "ds8b-autoscale-diurnal"


def preflight(sc):
    """Refuse to demo a spec whose static feasibility check errors out."""
    diags = sc.check()
    if diags:
        for d in diags:
            print(f"preflight: {sc.name}: {d.format()}", file=sys.stderr)
        sys.exit(2)
    return sc


def show_fleet(s, r):
    print(f"  ttft p95={r['ttft_s']['p95']*1e3:.0f}ms "
          f"tpot p95={r['tpot_s']['p95']*1e3:.1f}ms "
          f"migrations={s['n_migrations']} "
          f"(mean transfer {s['mean_transfer_s']*1e3:.2f}ms)")
    for wname, w in s["workers"].items():
        sat = w["time_to_saturation_s"]
        print(f"  {wname:6s} [{w['role']:9s}] "
              f"peak_kv={w['peak_kv_util']:.2f} "
              f"preempt={w['preemptions']:3d} "
              + (f"saturated@{sat:.1f}s" if sat is not None
                 else "never saturated"))


def main():
    for name in (*PAIR, MIXED, ELASTIC):
        preflight(get_scenario(name))
    base = get_scenario(PAIR[0])
    trace = base.trace()          # same trace for both fleets (same seed)
    slo = base.slo("interactive")
    print(f"== {base.traffic.n_requests} long-context reasoning requests, "
          f"Poisson {base.traffic.rate:.0f} req/s, {base.model.name} on "
          f"{base.n_devices}xH200 (sim) ==")
    want_report = "--report" in sys.argv[1:]
    for name in PAIR:
        sc = get_scenario(name)
        mode = "disaggregated" if sc.disaggregated else "colocated"
        rt = sc.to_cluster()
        build = attach(rt.events)     # obs tap: subscriber, metrics untouched
        rt.submit_trace(trace)
        m = rt.run()
        rep = build()
        s = m.summary(slo, regimes=regime_fractions(rep))
        print(f"\n[{mode}] finished={s['n_finished']}/{s['n_submitted']} "
              f"goodput={s['goodput_tok_s']:.0f}tok/s "
              f"(throughput={s['throughput_tok_s']:.0f}) "
              f"slo_attainment={s['slo_attainment']:.2f} "
              f"regime={s['regimes']['dominant']}")
        show_fleet(s, m.request_summary())
        if want_report:
            print(render_text(rep, title=name))
    print("\nPast the capacity knee the colocated fleet queues arrivals "
          "behind saturated KV pools (TTFT blows the SLO); the disaggregated "
          "fleet keeps TTFT flat and holds more goodput (paper Obs 1/3/4).")

    # ---- multi-tenant SLO classes on one fleet ----------------------------
    sc = get_scenario(MIXED)
    mix = dict(sc.traffic.class_mix)
    print(f"\n== mixed tenancy: {sc.traffic.n_requests} requests, "
          f"{mix['interactive']:.0%} interactive / {mix['batch']:.0%} batch, "
          f"Poisson {sc.traffic.rate:.0f} req/s, KV slice "
          f"{sc.class_kv_headroom:.0%} ==")
    rt = sc.to_cluster()
    rt.submit_trace(sc.trace())
    m = rt.run()
    s = m.summary(slos=sc.slo_map())
    print(f"[mixed] finished={s['n_finished']}/{s['n_submitted']} "
          f"fleet goodput={s['goodput_tok_s']:.0f}tok/s "
          f"attainment={s['slo_attainment']:.2f}")
    for cname, c in s["classes"].items():
        print(f"  {cname:12s} n={c['n']:3d} "
              f"attainment={c['slo_attainment']:.2f} "
              f"goodput={c['goodput_tok_s']:.0f}tok/s")
    print("Interactive requests jump waiting queues and keep a KV headroom "
          "slice; batch absorbs the backpressure (benchmarks/slo_tiers.py "
          "sweeps this against a class-blind baseline).")

    # ---- elastic autoscaling under diurnal load ---------------------------
    sc = get_scenario(ELASTIC)
    a = sc.autoscaler
    print(f"\n== elastic fleet: {sc.traffic.n_requests} requests on a "
          f"piecewise-rate day {sc.traffic.phases}, {a.policy} controller, "
          f"bounds [{a.min_workers}, {a.max_workers}] ==")
    rt = sc.to_cluster()
    rt.submit_trace(sc.trace())
    m = rt.run()
    s = m.summary(slo=sc.slo())
    print(f"[auto] finished={s['n_finished']}/{s['n_submitted']} "
          f"attainment={s['slo_attainment']:.2f} "
          f"goodput/worker-s={s['goodput_tok_per_worker_s']:.0f} "
          f"worker-seconds={s['worker_seconds']:.0f}")
    print("scaling timeline:")
    for e in m.scaling_events:
        print(f"  t={e.t:6.2f}s {e.kind:9s} {e.worker:6s} "
              f"[{e.role}] pool={e.pool_size}")
    # the peak-provisioned static fleet, for the worker-second comparison
    peak = dataclasses.replace(
        sc, autoscaler=None,
        fleet=(dataclasses.replace(sc.fleet[0], count=a.max_workers),))
    rt2 = peak.to_cluster()
    rt2.submit_trace(peak.trace())
    s2 = rt2.run().summary(slo=peak.slo())
    print(f"[peak-static x{a.max_workers}] "
          f"attainment={s2['slo_attainment']:.2f} "
          f"goodput/worker-s={s2['goodput_tok_per_worker_s']:.0f} "
          f"worker-seconds={s2['worker_seconds']:.0f}")
    ratio = s["goodput_tok_per_worker_s"] \
        / max(s2["goodput_tok_per_worker_s"], 1e-9)
    print(f"The controller rides the 5x swing: same attainment at "
          f"{ratio:.2f}x the peak fleet's goodput per worker-second "
          f"(benchmarks/autoscale.py asserts the claims).")


if __name__ == "__main__":
    main()
