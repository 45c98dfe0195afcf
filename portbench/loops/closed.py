"""One client, closed loop: a unit is one request, sent once the one before
it has returned. The traced part runs until every target length of the mix
has been seen and at least ``min_requests`` were traced, or
``max_requests`` were."""

from ..traffic.generator import lengths

SERVES = "serve_one"


def units(session):
    return session.requests()


def traced_enough(mix, traced) -> bool:
    tc, n = mix["trace"], len(traced)
    return n >= tc["max_requests"] or (n >= tc["min_requests"] and {r.target for r in traced} >= lengths(mix))


def tally(run):
    return len(run.records), len(run.failures)
