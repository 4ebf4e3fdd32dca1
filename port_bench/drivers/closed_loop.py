"""A closed loop of clients, each sending one request and waiting for its answer.

Traffic keys: ``clients``, ``pool`` (window queries drawn from the seed and
sent in order, none twice while the pool lasts), ``strata`` (the pool laid
out in blocks that each hold one query of every band of its cost key,
``gen/queries.py:stratified``), ``warm_queries`` (a second
draw, served in set-up so that no first-use cost and no cold cache falls in
the window) and ``mix`` (``gen/queries.py:mix``).  One thread sends: a
client's next request goes out when its answer comes back, so ``clients``
requests are out at once without a thread apiece contending with the
program's own for the interpreter.  A request's latency runs from its
submit to its answer, on the host clock.  Clients stop sending when the
window closes; requests still out are awaited (up to ``LATE_S``) and judged,
but only answers that came inside the window count toward the rate.  With
``trace`` the program's tracer records spans, and nvidia-smi samples the
card, over the window.  The memory reading is the card's use with the
deployment serving (every process's context, pools and tensors, sampled at
the window's end, and every 100 ms with ``trace``), less the card's use
before the run: set-up's own peak in this process (the collection drawn and
the model trained) is not what the deployment holds.  A fixed loop of pure
Python, timed just before and after the window, prints the host's speed.
"""
from __future__ import annotations

import queue
import sys
import time

import numpy as np

from port_bench.devtrace import Smi, card_memory_used_bytes

LATE_S = 60.0


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed for one thread."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x ^= i
    return (time.perf_counter() - t0) * 1e3


def _serve(system, rows: np.ndarray, clients: int, deadline: float | None):
    """Run the loop over ``rows`` until they run out or ``deadline`` passes
    -> [(row index, t_submit, t_done, outcome or None)]."""
    answers: queue.SimpleQueue = queue.SimpleQueue()
    out: list = []
    sent = 0

    def send() -> bool:
        nonlocal sent
        if (deadline is None and sent >= len(rows)) or \
                (deadline is not None and time.perf_counter() >= deadline):
            return False
        i, t0 = sent, time.perf_counter()
        sent += 1
        system.submit(rows[i % len(rows)]).add_done_callback(
            lambda f: answers.put((i, t0, time.perf_counter(), f)))
        return True

    out_now = sum(send() for _ in range(clients))
    give_up = (deadline or time.perf_counter()) + LATE_S
    while out_now:
        try:
            i, t0, t1, f = answers.get(timeout=max(give_up - time.perf_counter(), 0.0))
        except queue.Empty:  # never answered: recorded as failed
            break
        try:
            res = f.result()
        except Exception:  # a request that fails is recorded as failed
            res = None
        out.append((i, t0, t1, res))
        out_now -= 1
        out_now += send()
    answered = {i for i, *_ in out}
    out += [(i, 0.0, float("inf"), None) for i in range(sent) if i not in answered]
    return out


def drive(system, traffic: dict, seed: int, seconds: float, trace: bool, setup) -> dict:
    rng = np.random.default_rng([seed, 1])
    with setup.stage("traffic"):
        pool = system.query_pool(rng, traffic["pool"], traffic["mix"], traffic.get("strata"))
        warm = system.query_pool(np.random.default_rng([seed, 2]), traffic["warm_queries"],
                                 traffic["mix"])
    with setup.stage("warm_traffic"):
        _serve(system, warm, traffic["clients"], None)
    probe = host_probe_ms()
    smi = Smi() if trace else None
    tracer = None
    if trace:
        from repro_torch.obs import Tracer

        tracer = Tracer()
        system.set_trace(tracer)
    t_start = setup.window_started()
    t_end = t_start + seconds
    try:
        done = _serve(system, pool, traffic["clients"], t_end)
    finally:
        if trace:
            system.set_trace(None)
            smi.stop()
    print(f"[port_bench] host probe before / after the window: {probe:.1f} / "
          f"{host_probe_ms():.1f} ms", file=sys.stderr, flush=True)
    rec = {
        "window_s": t_end - t_start,
        "attempted": len(done),
        "latency_s": [t1 - t0 for _, t0, t1, r in done if r is not None and r.ok and t1 <= t_end],
        "failed": sum(1 for *_, r in done if r is None or not r.ok),
        "answered_in_window": sum(1 for _, _, t1, r in done
                                  if r is not None and r.ok and t1 <= t_end),
        "queue_us": [r.queue_us for *_, r in done if r is not None and r.ok],
    }
    if trace:
        rec["spans"] = [(s.name, s.pid, s.tid, s.ts_us, s.dur_us) for s in tracer.spans]
        rec["smi"] = smi.between(t_start, t_end)
        util = [u for _, u, _ in rec["smi"]]
        rec["busy_s"] = (sum(util) / len(util) / 100.0 * rec["window_s"]) if util else None
    # the deployment serving: every process on the card, less the card before the run
    rec["memory_peak_bytes"] = 0
    if system.device.type == "cuda":
        used = [u for u in [card_memory_used_bytes()] if u is not None]
        used += [int(mib * 2 ** 20) for *_, mib in rec.get("smi", ())]
        if not used:
            raise RuntimeError("nvidia-smi gave no reading of the card's memory")
        rec["memory_peak_bytes"] = max(used) - system.card_base_bytes
    rec["to_check"] = [(pool[i % len(pool)], r.ids) for i, _, _, r in done
                       if r is not None and r.ok]
    return rec
