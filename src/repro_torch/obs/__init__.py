"""positscope — numerics and performance observability (counterpart of
``repro.obs``).

Opt-in telemetry for the posit stack, free when no collector is open::

    from repro_torch import obs

    with obs.scoped() as m:
        (x_hi, x_lo), _ = refine.rgesv_ir(a_p, b_p)
    print(m.to_json())                      # counters/gauges/hists/series
    m.save_chrome_trace("solve_trace.json") # open in Perfetto

Three layers:

* ``obs.metrics``  — process-local registry (counters, gauges, fixed-log2
  histograms, series) behind the ``scoped()`` collector stack;
* ``obs.trace``    — nested wall-clock spans -> Chrome trace_event JSON,
  forwarded to ``torch.profiler.record_function``;
* ``obs.numerics`` — posit-word telemetry (golden-zone occupancy,
  regime/scale histograms, encode rounding/sticky counters, quire
  limb-carry counts) and the ``active()`` gate.

With a collector open, the hooked entry points (``rgemm``, ``rpotrf``,
``rgetrf``, ``rgeqrf``, ``refine_pair`` and the drivers above them)
record the reference's keys with the reference's values, and only where
the reference records: a call that the reference makes inside a jitted
or vmapped program records nothing in either package.  With none open
they run the code they ran before the hooks, and no function of
``obs.numerics`` is called.
"""
from repro_torch.obs.metrics import (Collector, enabled, gauge, inc, observe,
                                     observe_hist, record, scoped)
from repro_torch.obs.numerics import (active, collect_numerics,
                                      encode_round_stats, golden_zone_bounds,
                                      golden_zone_fraction, is_concrete,
                                      quire_carry_stats, record_encode_stats,
                                      record_numerics, record_quire_carries,
                                      step_stats)
from repro_torch.obs.trace import span

__all__ = [
    "Collector", "enabled", "gauge", "inc", "observe", "observe_hist",
    "record", "scoped", "span", "active", "collect_numerics",
    "encode_round_stats", "golden_zone_bounds", "golden_zone_fraction",
    "is_concrete", "quire_carry_stats", "record_encode_stats",
    "record_numerics", "record_quire_carries", "step_stats",
]
