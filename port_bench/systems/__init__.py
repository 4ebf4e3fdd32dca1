"""Systems under test, one module each, named by a configuration's ``system``.

A module's ``build(config, seed, device, setup, control=False)`` makes the
inputs from the seed, builds the port's serving path on them (timing each
stage on ``setup``) and returns an object that a traffic driver drives and
that checks, after ``close()``, what the path produced against the plain
reference.
"""
