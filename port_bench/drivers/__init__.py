"""Traffic drivers, one module each, named by a traffic file's ``driver``.

A module's ``drive(system, traffic, seed, seconds, trace, setup)`` draws
the traffic from the seed (set-up), warms the system's shapes (set-up),
opens the window with ``setup.window_started()``, drives the system for
``seconds`` and returns the window's record: what the metric readers
reduce and, under ``to_check``, what the system's reference judges.
"""
