"""The health sentinel: a low-overhead supervisor evaluating the
declarative rule table and actuating closed-loop responses.

Counterpart of ``roaringbitmap_tpu/observe/sentinel.py``.
``observe.health`` defines WHAT healthy means (rules, bands, hysteresis,
flap suppression); this module decides WHEN to judge and WHAT TO DO about
a verdict:

* **Pacing** — three ways to drive ticks, all sharing one
  :class:`Sentinel`:

  - ``tick()`` — explicit, with an injectable ``now`` (a fake clock makes
    the tests deterministic);
  - ``start()``/``stop()`` — an opt-in daemon thread
    (``RB_TPU_SENTINEL=on`` at import, interval
    ``RB_TPU_SENTINEL_INTERVAL_S``, default 5 s);
  - ``maybe_tick()`` — an inline pacing hook at the top of the
    aggregation dispatch (``RB_TPU_SENTINEL=inline`` /
    ``configure(inline=True)``): a single-threaded serving loop gets
    supervision without a thread. Off (the default) it is ONE module-bool
    check.

* **Judgement** — each tick builds a :class:`health.Snapshot` OUTSIDE
  the sentinel lock (gathering takes the registry, ladder and ledger leaf
  locks, and reconciles the pack caches against the card), runs every
  rule probe against it, then steps the per-rule state machines under
  the sentinel lock. The sentinel lock is a LEAF: metrics, instants and
  actuations all happen outside it.

* **Actuation**, per the rule table's actuation column:

  - ``"refit"`` (costmodel-drift): while the rule is at WARN or worse,
    ``cost.refit_all()`` under a cooldown
    (``RB_TPU_SENTINEL_REFIT_COOLDOWN_S``, default 60 s);
  - ``"maintain"`` (structure-drift / delta-accretion): one priced
    maintenance pass, ``serve.maintain.run_pass``, under its own
    cooldown (``RB_TPU_SENTINEL_MAINTAIN_COOLDOWN_S``, default 30 s);
  - ``"autotune"`` (serving-p99-pressure): the fusion window's
    ``query.fusion.autotune_window`` under its own cooldown
    (``RB_TPU_SENTINEL_AUTOTUNE_COOLDOWN_S``, default 30 s);
  - ``"alert"``: on the fire transition, a structured ``sentinel.alert``
    recorder instant and decision-log entry carrying the rule, value and
    threshold — once per episode, not per tick;
  - any rule reaching CRITICAL: a one-shot **flight bundle**
    (``observe.bundle``) per red episode, cooldown-guarded
    (``RB_TPU_SENTINEL_BUNDLE_COOLDOWN_S``, default 300 s).

  Every actuation reaches its target; a target that raises records its
  error in the actuation log, as the JAX package's failure path does, and
  its rules stay firing.

Every tick exports ``rb_tpu_health_status`` (process rollup) and
``rb_tpu_health_rule_state{rule}``; actuations count in
``rb_tpu_health_actuation_total{rule,kind}``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import health as _health
from . import registry as _registry
from . import timeline as _timeline

DEFAULT_INTERVAL_S = 5.0
DEFAULT_REFIT_COOLDOWN_S = 60.0
DEFAULT_BUNDLE_COOLDOWN_S = 300.0
DEFAULT_MAINTAIN_COOLDOWN_S = 30.0
DEFAULT_AUTOTUNE_COOLDOWN_S = 30.0

_ACTUATION_TOTAL = _registry.counter(
    _registry.HEALTH_ACTUATION_TOTAL,
    "Sentinel closed-loop actuations by rule and kind "
    "(refit | maintain | autotune | alert | bundle)",
    ("rule", "kind"),
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    try:
        return float(raw) if raw else default
    except ValueError:  # malformed env must not break package import
        return default


class Sentinel:
    """Rule-table supervisor. All mutable state lives behind ``_lock``
    (a LEAF — see the module docstring); the clock is injectable so
    cooldown/hysteresis tests run on a fake timeline."""

    def __init__(
        self,
        rules: Optional[Tuple[_health.Rule, ...]] = None,
        clock=time.monotonic,
        refit_cooldown_s: Optional[float] = None,
        bundle_cooldown_s: Optional[float] = None,
        maintain_cooldown_s: Optional[float] = None,
        autotune_cooldown_s: Optional[float] = None,
    ):
        self.rules: Tuple[_health.Rule, ...] = tuple(
            _health.DEFAULT_RULES if rules is None else rules
        )
        self._clock = clock
        self.refit_cooldown_s = (
            _env_float("RB_TPU_SENTINEL_REFIT_COOLDOWN_S", DEFAULT_REFIT_COOLDOWN_S)
            if refit_cooldown_s is None else float(refit_cooldown_s)
        )
        self.bundle_cooldown_s = (
            _env_float("RB_TPU_SENTINEL_BUNDLE_COOLDOWN_S", DEFAULT_BUNDLE_COOLDOWN_S)
            if bundle_cooldown_s is None else float(bundle_cooldown_s)
        )
        self.maintain_cooldown_s = (
            _env_float(
                "RB_TPU_SENTINEL_MAINTAIN_COOLDOWN_S",
                DEFAULT_MAINTAIN_COOLDOWN_S,
            )
            if maintain_cooldown_s is None else float(maintain_cooldown_s)
        )
        self.autotune_cooldown_s = (
            _env_float(
                "RB_TPU_SENTINEL_AUTOTUNE_COOLDOWN_S",
                DEFAULT_AUTOTUNE_COOLDOWN_S,
            )
            if autotune_cooldown_s is None else float(autotune_cooldown_s)
        )
        self._lock = threading.Lock()  # leaf: guards the fields below only
        self._states: Dict[str, _health.RuleState] = {  # guarded-by: self._lock
            r.name: _health.RuleState() for r in self.rules
        }
        self._tick_no = 0  # guarded-by: self._lock
        self._status = _health.OK  # guarded-by: self._lock
        self._prev_sums: Dict[str, float] = {}  # guarded-by: self._lock
        self._actuations: "deque[dict]" = deque(maxlen=64)  # guarded-by: self._lock
        self._last_refit: Optional[float] = None  # guarded-by: self._lock
        self._last_bundle: Optional[float] = None  # guarded-by: self._lock
        self._last_maintain: Optional[float] = None  # guarded-by: self._lock
        self._last_autotune: Optional[float] = None  # guarded-by: self._lock

    # -- the tick -----------------------------------------------------------

    def tick(self, now: Optional[float] = None, snap=None) -> dict:
        """One supervision cycle: snapshot → judge → export → actuate.
        ``now`` pins the clock (tests); ``snap`` injects a pre-built
        snapshot (the hammer fabricates cheap ones)."""
        if now is None:
            now = self._clock()
        if snap is None:
            with self._lock:
                prev = dict(self._prev_sums)
            snap = _health.snapshot(prev_sums=prev, now=now)
        # probes run OUTSIDE the sentinel lock: they read other
        # subsystems' (leaf-locked) registries
        values: Dict[str, Optional[float]] = {}
        probe_errors: Dict[str, str] = {}
        for rule in self.rules:
            try:
                v = rule.probe(snap)
                values[rule.name] = float(v) if v is not None else None
            except Exception as e:  # rb-ok: exception-hygiene -- one broken probe must not kill the supervisor; the error is surfaced in the tick report and the rule judges no-data
                values[rule.name] = None
                probe_errors[rule.name] = f"{type(e).__name__}: {e}"
        alerts: List[dict] = []
        refit_due: Optional[str] = None
        maintain_due: Optional[str] = None
        autotune_due: Optional[str] = None
        bundle_due: Optional[List[str]] = None
        with self._lock:
            self._tick_no += 1
            tick_no = self._tick_no
            evals: Dict[str, dict] = {}
            status = _health.OK
            for rule in self.rules:
                st = self._states[rule.name]
                ev = st.step(rule, values[rule.name], tick_no)
                evals[rule.name] = ev
                status = max(status, st.level)
                tr = ev["transition"]
                if (
                    tr is not None and tr[1] > tr[0]
                    and rule.actuation == "alert"
                ):
                    alerts.append({
                        "rule": rule.name, "value": ev["value"],
                        "level": ev["level"], "warn": rule.warn,
                        "critical": rule.critical,
                    })
                if (
                    rule.actuation == "refit"
                    and st.level >= _health.WARN
                    and refit_due is None
                    and (
                        self._last_refit is None
                        or now - self._last_refit >= self.refit_cooldown_s
                    )
                ):
                    self._last_refit = now
                    refit_due = rule.name
                if (
                    rule.actuation == "maintain"
                    and st.level >= _health.WARN
                    and maintain_due is None
                    and (
                        self._last_maintain is None
                        or now - self._last_maintain >= self.maintain_cooldown_s
                    )
                ):
                    self._last_maintain = now
                    maintain_due = rule.name
                if (
                    rule.actuation == "autotune"
                    and st.level >= _health.WARN
                    and autotune_due is None
                    and (
                        self._last_autotune is None
                        or now - self._last_autotune >= self.autotune_cooldown_s
                    )
                ):
                    self._last_autotune = now
                    autotune_due = rule.name
            prev_status = self._status
            self._status = status
            self._prev_sums.update(snap.sums)
            if (
                status >= _health.CRITICAL
                and prev_status < _health.CRITICAL
                and (
                    self._last_bundle is None
                    or now - self._last_bundle >= self.bundle_cooldown_s
                )
            ):
                self._last_bundle = now
                bundle_due = [
                    r.name for r in self.rules
                    if self._states[r.name].level >= _health.CRITICAL
                ]
        # -- export + actuate, all OUTSIDE the sentinel lock --------------
        _health.HEALTH_STATUS.set(status)
        for rule in self.rules:
            _health.HEALTH_RULE_STATE.set(evals[rule.name]["level"], (rule.name,))
        self._emit_transitions(evals)
        actuated: List[dict] = []
        for a in alerts:
            actuated.append(self._actuate_alert(now, tick_no, a))
        if refit_due is not None:
            actuated.append(self._actuate_refit(now, tick_no, refit_due))
        if maintain_due is not None:
            actuated.append(self._actuate_maintain(now, tick_no, maintain_due))
        if autotune_due is not None:
            actuated.append(self._actuate_autotune(now, tick_no, autotune_due))
        if bundle_due is not None:
            actuated.append(self._actuate_bundle(now, tick_no, bundle_due, evals))
        if actuated:
            with self._lock:
                self._actuations.extend(actuated)
        report = {
            "tick": tick_no,
            "status": status,
            "status_name": _health.STATUS_NAMES[status],
            "rules": evals,
            "actuated": actuated,
        }
        if probe_errors:
            report["probe_errors"] = probe_errors
        return report

    def _emit_transitions(self, evals: Dict[str, dict]) -> None:
        from . import decisions as _decisions

        for name, ev in evals.items():
            tr = ev["transition"]
            if tr is None:
                continue
            frm, to = _health.LEVEL_NAMES[tr[0]], _health.LEVEL_NAMES[tr[1]]
            if _timeline.enabled():
                _timeline.instant(
                    "health.transition", "health", rule=name,
                    frm=frm, to=to, value=ev["value"],
                )
            _decisions.record_decision(
                "sentinel.rule", f"{frm}->{to}", rule=name, value=ev["value"],
            )

    # -- actuations ---------------------------------------------------------

    def _actuate_alert(self, now, tick_no, a) -> dict:
        from . import decisions as _decisions

        _ACTUATION_TOTAL.inc(1, (a["rule"], "alert"))
        _timeline.instant(
            "sentinel.alert", "health", rule=a["rule"], value=a["value"],
            level=_health.LEVEL_NAMES[a["level"]], warn=a["warn"],
            critical=a["critical"],
        )
        _decisions.record_decision(
            "sentinel.actuate", "alert", rule=a["rule"], value=a["value"],
            level=_health.LEVEL_NAMES[a["level"]],
        )
        return {"tick": tick_no, "ts": now, "kind": "alert", **a}

    def _actuate_refit(self, now, tick_no, rule_name: str) -> dict:
        from . import decisions as _decisions

        _ACTUATION_TOTAL.inc(1, (rule_name, "refit"))
        entry = {"tick": tick_no, "ts": now, "kind": "refit", "rule": rule_name}
        try:
            from .. import cost as _cost

            reports = _cost.refit_all()
            entry["authorities"] = {
                name: {
                    "moved": sorted(rep.get("moved") or {}),
                    "provenance": rep.get("provenance"),
                    "refused": rep.get("refused"),
                }
                for name, rep in reports.items()
            }
        except Exception as e:  # rb-ok: exception-hygiene -- a failed refit leaves the calibrated coefficients in place; the failure is recorded in the actuation log and the drift rule stays firing
            entry["error"] = f"{type(e).__name__}: {e}"
        _timeline.instant(
            "sentinel.refit", "health", rule=rule_name,
            moved=sum(
                len(a.get("moved") or ())
                for a in entry.get("authorities", {}).values()
            ),
        )
        _decisions.record_decision(
            "sentinel.actuate", "refit", rule=rule_name,
            error=entry.get("error"),
        )
        return entry

    def _actuate_maintain(self, now, tick_no, rule_name: str) -> dict:
        from . import decisions as _decisions

        _ACTUATION_TOTAL.inc(1, (rule_name, "maintain"))
        entry = {
            "tick": tick_no, "ts": now, "kind": "maintain", "rule": rule_name,
        }
        try:
            from ..serve import maintain as _maintain

            record = _maintain.run_pass(reason=f"sentinel:{rule_name}")
            entry["outcome"] = record.get("outcome")
            entry["reclaimed_bytes"] = record.get("reclaimed_bytes")
            entry["rewritten_keys"] = record.get("rewritten_keys")
        except Exception as e:  # rb-ok: exception-hygiene -- a failed pass leaves the uncompacted epoch in place; the failure is recorded in the actuation log and the structure rules stay firing
            entry["error"] = f"{type(e).__name__}: {e}"
        _timeline.instant(
            "sentinel.maintain", "health", rule=rule_name,
            outcome=entry.get("outcome"),
        )
        _decisions.record_decision(
            "sentinel.actuate", "maintain", rule=rule_name,
            pass_outcome=entry.get("outcome"), error=entry.get("error"),
        )
        return entry

    def _actuate_autotune(self, now, tick_no, rule_name: str) -> dict:
        from . import decisions as _decisions

        _ACTUATION_TOTAL.inc(1, (rule_name, "autotune"))
        entry = {
            "tick": tick_no, "ts": now, "kind": "autotune", "rule": rule_name,
        }
        try:
            from ..query import fusion as _fusion

            record = _fusion.autotune_window(reason=f"sentinel:{rule_name}")
            entry["verdict"] = record.get("verdict")
            entry["window_from"] = record.get("window_from")
            entry["window_to"] = record.get("window_to")
            entry["budget_ms"] = record.get("budget_ms")
        except Exception as e:  # rb-ok: exception-hygiene -- a failed auto-tune leaves the current window bounds in place; the failure is recorded in the actuation log and the pressure rule stays firing
            entry["error"] = f"{type(e).__name__}: {e}"
        _timeline.instant(
            "sentinel.autotune", "health", rule=rule_name,
            verdict=entry.get("verdict"), window_to=entry.get("window_to"),
        )
        _decisions.record_decision(
            "sentinel.actuate", "autotune", rule=rule_name,
            tune_verdict=entry.get("verdict"), error=entry.get("error"),
        )
        return entry

    def _actuate_bundle(self, now, tick_no, red_rules, evals) -> dict:
        from . import bundle as _bundle
        from . import decisions as _decisions

        for name in red_rules:
            _ACTUATION_TOTAL.inc(1, (name, "bundle"))
        reason = red_rules[0] if red_rules else "red"
        entry = {
            "tick": tick_no, "ts": now, "kind": "bundle",
            "rules": list(red_rules),
        }
        try:
            entry["path"] = _bundle.write_bundle(
                reason,
                trigger={
                    "rules": {
                        name: {
                            "value": evals[name]["value"],
                            "level": _health.LEVEL_NAMES[evals[name]["level"]],
                        }
                        for name in red_rules
                    },
                    "tick": tick_no,
                },
                health_dump=self.health_dump(),
            )
        except Exception as e:  # rb-ok: exception-hygiene -- a bundle that cannot be written (disk full at the worst moment) must not kill the supervisor; the failure is recorded in the actuation log
            entry["error"] = f"{type(e).__name__}: {e}"
        _timeline.instant(
            "sentinel.bundle", "health", rules=",".join(red_rules),
            path=entry.get("path"),
        )
        _decisions.record_decision(
            "sentinel.actuate", "bundle", rules=",".join(red_rules),
            error=entry.get("error"),
        )
        return entry

    # -- read APIs ----------------------------------------------------------

    def status(self) -> Tuple[int, str]:
        with self._lock:
            return self._status, _health.STATUS_NAMES[self._status]

    def rule_states(self) -> Dict[str, dict]:
        """{rule: state + thresholds} — the health panel's rows."""
        with self._lock:
            out = {}
            for rule in self.rules:
                st = self._states[rule.name]
                out[rule.name] = {
                    **st.as_dict(),
                    "warn": rule.warn,
                    "critical": rule.critical,
                    "actuation": rule.actuation,
                }
            return out

    def actuations(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            entries = list(self._actuations)
        if n is not None:
            entries = entries[-int(n):] if n > 0 else []
        return [dict(e) for e in entries]

    def history(self, rule: str, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            h = list(self._states[rule].history)
        return h[-int(n):] if n else h

    def health_dump(self) -> dict:
        """The bundle's health.json: status, per-rule state + evaluation
        history, and the actuation log."""
        with self._lock:
            return {
                "status": self._status,
                "status_name": _health.STATUS_NAMES[self._status],
                "tick": self._tick_no,
                "rules": {
                    rule.name: {
                        **self._states[rule.name].as_dict(),
                        "warn": rule.warn,
                        "critical": rule.critical,
                        "actuation": rule.actuation,
                        "history": list(self._states[rule.name].history),
                    }
                    for rule in self.rules
                },
                "actuations": list(self._actuations),
            }

    def reset(self) -> None:
        """Drop all evaluation state (tests, measurement windows); the rule
        table and cooldown policy stay."""
        with self._lock:
            self._states = {r.name: _health.RuleState() for r in self.rules}
            self._tick_no = 0
            self._status = _health.OK
            self._prev_sums = {}
            self._actuations.clear()
            self._last_refit = None
            self._last_bundle = None
            self._last_maintain = None
            self._last_autotune = None


# The process-wide sentinel (the thread and the inline hook drive this
# instance).
SENTINEL = Sentinel()

_THREAD_LOCK = threading.Lock()
_THREAD: Optional[threading.Thread] = None  # guarded-by: _THREAD_LOCK
_STOP = threading.Event()

# inline pacing (maybe_tick): OFF by default — the hook on the dispatch
# path is then one module-bool check, nothing allocated (pinned by test)
_INLINE = False
_INLINE_INTERVAL_NS = int(DEFAULT_INTERVAL_S * 1e9)
_NEXT_TICK_NS = 0


def maybe_tick() -> bool:
    """Inline pacing hook (called from the aggregation dispatch path):
    ticks the process sentinel at most once per interval, and only when
    inline mode is armed. The off path is one bool check."""
    if not _INLINE:
        return False
    global _NEXT_TICK_NS
    now = time.monotonic_ns()
    if now < _NEXT_TICK_NS:
        return False
    # racy window is benign: two threads can at worst tick back-to-back
    _NEXT_TICK_NS = now + _INLINE_INTERVAL_NS
    SENTINEL.tick()
    return True


def start(interval_s: Optional[float] = None) -> None:
    """Start the opt-in supervision thread (idempotent)."""
    global _THREAD
    if interval_s is None:
        interval_s = _env_float("RB_TPU_SENTINEL_INTERVAL_S", DEFAULT_INTERVAL_S)
    with _THREAD_LOCK:
        if _THREAD is not None and _THREAD.is_alive():
            return
        _STOP.clear()

        def _loop():
            while not _STOP.wait(interval_s):
                try:
                    SENTINEL.tick()
                except Exception:  # rb-ok: exception-hygiene -- the supervisor thread must survive any single bad tick; the next interval retries with fresh state
                    pass

        _THREAD = threading.Thread(
            target=_loop, name="rb-sentinel", daemon=True
        )
        _THREAD.start()


def stop() -> None:
    """Stop the supervision thread (no-op when not running)."""
    global _THREAD
    with _THREAD_LOCK:
        t = _THREAD
        _THREAD = None
        if t is not None:
            # set the stop flag INSIDE the lock: a concurrent start()
            # serializes behind us and clears the event for ITS thread —
            # setting it after releasing would race that clear and kill
            # the freshly started supervisor on its first wait
            _STOP.set()
    if t is not None:
        t.join(timeout=5.0)


def running() -> bool:
    with _THREAD_LOCK:
        return _THREAD is not None and _THREAD.is_alive()


def configure(
    inline: Optional[bool] = None,
    inline_interval_s: Optional[float] = None,
    refit_cooldown_s: Optional[float] = None,
    bundle_cooldown_s: Optional[float] = None,
    maintain_cooldown_s: Optional[float] = None,
    autotune_cooldown_s: Optional[float] = None,
) -> None:
    """Runtime overrides for the process sentinel: arm/disarm the inline
    pacing hook and adjust the actuation cooldowns."""
    global _INLINE, _INLINE_INTERVAL_NS, _NEXT_TICK_NS
    if inline is not None:
        _INLINE = bool(inline)
        _NEXT_TICK_NS = 0
    if inline_interval_s is not None:
        _INLINE_INTERVAL_NS = int(float(inline_interval_s) * 1e9)
        _NEXT_TICK_NS = 0
    if refit_cooldown_s is not None:
        SENTINEL.refit_cooldown_s = float(refit_cooldown_s)
    if bundle_cooldown_s is not None:
        SENTINEL.bundle_cooldown_s = float(bundle_cooldown_s)
    if maintain_cooldown_s is not None:
        SENTINEL.maintain_cooldown_s = float(maintain_cooldown_s)
    if autotune_cooldown_s is not None:
        SENTINEL.autotune_cooldown_s = float(autotune_cooldown_s)


def _init_from_env() -> None:
    raw = os.environ.get("RB_TPU_SENTINEL", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return
    if raw == "inline":
        configure(inline=True)
    else:  # "on"/"1"/"thread"/anything truthy: the background thread
        start()


_init_from_env()
