"""Phased DKG driver: DistKeyGenerator state machine x EchoBroadcast board
(reference: the kyber TimePhaser + dkg.Protocol loop wired in
core/drand_beacon_control.go:333-411 and core/broadcast.go).

FastSync phasing: each phase ends when every expected bundle arrived or its
timeout elapsed — one response round suffices when nobody misbehaves.

`run_dkg_bounded` is the crash-hygiene wrapper the control RPC actually
calls: the whole session runs on a worker thread under ONE overall
deadline (sum of the phase budgets plus slack) so a wedged board collect —
e.g. a frozen injected clock, or a board whose queue never drains — can
never hang the InitDKG/InitReshare RPC forever.  On timeout the caller
raises, its `finally` stops the board, and the abandoned worker unwinds
promptly because `collect` exits when the board stops.

The port's copy of drand_tpu/core/dkg_runner.py, unchanged but for its imports.
"""

import threading
from typing import Callable, Optional

from ..crypto import dkg as D
from ..log import Logger

# extra REAL seconds granted past the clock-based session deadline before
# the wrapper abandons the worker (a frozen FakeClock must not wedge a
# control RPC; production RealClock sessions hit the clock deadline first)
SESSION_REAL_SLACK = 60.0


def run_dkg(gen: D.DistKeyGenerator, board, clock, phase_timeout: int,
            log: Logger, first_phase_extra: float = 0.0,
            on_phase: Optional[Callable[[str], None]] = None) -> D.DkgOutput:
    """Drive one node through a DKG/reshare session; returns DkgOutput.

    `board` is an EchoBroadcast (or harness fake) exposing deal/response/
    justification queues + to_network() + collect().

    `first_phase_extra` pads the DEAL deadline only: the leader sits out a
    kickoff grace before dealing, so followers must not let their first
    phase expire inside that window — expiring early would finalize with a
    smaller QUAL than the rest of the group and fork the collective key
    (the group hash does not cover post-DKG commits, so such a fork is
    silent until beacon verification fails).

    `on_phase` is the journal hook (core/dkg_journal.py): called with the
    phase name as each phase begins, so a crash-restart can report how far
    the dead session got."""
    def note(phase: str) -> None:
        if on_phase is not None:
            try:
                on_phase(phase)
            except Exception:
                pass        # journaling must never fail the session

    n_dealers = len(gen.dealers)
    n_holders = len(gen.holders)

    # Phase 1 — deals (dealers only produce; everyone collects).
    note("deal")
    my_deal = gen.generate_deals()
    if my_deal is not None:
        board.to_network(my_deal)
    deadline = clock.now() + phase_timeout + first_phase_extra
    deals = board.collect(board.deals, n_dealers, deadline, clock)
    log.info("dkg: deal phase done", got=len(deals), want=n_dealers)

    # Phase 2 — responses (share holders only produce; everyone collects).
    note("response")
    my_resp = gen.process_deal_bundles(deals)
    if my_resp is not None:
        board.to_network(my_resp)
    deadline = clock.now() + phase_timeout
    resps = board.collect(board.responses, n_holders, deadline, clock)
    log.info("dkg: response phase done", got=len(resps), want=n_holders)

    output, my_just = gen.process_response_bundles(resps)
    if output is not None:
        return output

    # Phase 3 — justifications (only dealers under complaint produce).
    note("justification")
    if my_just is not None:
        board.to_network(my_just)
    deadline = clock.now() + phase_timeout
    justs = board.collect(board.justifications, n_dealers, deadline, clock)
    log.info("dkg: justification phase done", got=len(justs))
    return gen.process_justification_bundles(justs)


def run_dkg_bounded(gen: D.DistKeyGenerator, board, clock,
                    phase_timeout: int, log: Logger,
                    first_phase_extra: float = 0.0,
                    on_phase: Optional[Callable[[str], None]] = None,
                    session_budget: Optional[float] = None,
                    real_cap: Optional[float] = None) -> D.DkgOutput:
    """`run_dkg` under an overall session deadline.

    The session runs on a worker thread; this thread waits for it with
    BOTH an injected-clock budget (`session_budget`, default = the three
    phase windows + first-phase extra + slack) and a real-seconds cap
    (`real_cap`, default = budget + SESSION_REAL_SLACK).  Whichever trips
    first raises TimeoutError — the caller's board teardown then unwinds
    the worker (collect exits once the board is stopped), so no thread is
    left spinning against a dead session."""
    if session_budget is None:
        session_budget = 3.0 * phase_timeout + first_phase_extra + 15.0
    if real_cap is None:
        real_cap = session_budget + SESSION_REAL_SLACK
    deadline = clock.now() + session_budget
    done = threading.Event()
    result: dict = {}
    # once the session is abandoned, the unwinding worker must go MUTE:
    # its late phase transitions would scribble over the journal/gauge of
    # the failed (or a newer retry) session
    live = threading.Event()
    live.set()

    def muted_on_phase(phase):
        if live.is_set() and on_phase is not None:
            on_phase(phase)

    def worker():
        try:
            result["out"] = run_dkg(gen, board, clock, phase_timeout, log,
                                    first_phase_extra=first_phase_extra,
                                    on_phase=muted_on_phase)
        except BaseException as e:          # noqa: BLE001 — relayed below
            result["err"] = e
        finally:
            done.set()

    # deliberately never joined: on the deadline path the worker may be
    # wedged inside board.collect — joining would re-introduce the exact
    # hang this budget exists to escape; `live` mutes the abandoned worker
    # tpu-vet: disable=threadlife
    t = threading.Thread(target=worker, daemon=True, name="dkg-session")
    t.start()
    import time as _t                 # real-seconds cap only; waits below
    t0 = _t.monotonic()               # tpu-vet: disable=clock
    while not done.is_set():
        if clock.now() >= deadline or _t.monotonic() - t0 >= real_cap:  # tpu-vet: disable=clock
            live.clear()
            log.error("dkg session deadline exceeded; abandoning",
                      budget=session_budget)
            raise TimeoutError(
                f"dkg session exceeded its {session_budget:.0f}s budget "
                "(wedged board collect?)")
        done.wait(0.1)
    if "err" in result:
        raise result["err"]
    return result["out"]
