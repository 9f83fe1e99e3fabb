"""The replica fault-drill contract of the HTTP front end.

A ``fault_hook`` is any callable ``hook(site, n)``: the front end calls it
once per ``/predict`` with site ``"request"`` and once per ``/healthz``
probe with site ``"health"``, ``n`` counting that site's calls from 1.  It
may return (no fault), sleep, or raise ``InjectedReject``, which the front
end answers with 503.  No hook, no cost."""


class InjectedReject(RuntimeError):
    """The reject drill: the HTTP front end answers 503 at this site."""
