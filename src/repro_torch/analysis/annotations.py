"""Thread-ownership annotations the race lint builds its map from.

These are RUNTIME NO-OPS — they tag the function/class and return it
unchanged, so annotating a hot control-plane method costs nothing. The
contract they declare is for a static race lint that reads the
decorator NAMES from the AST (no import of the annotated module is
needed); the JAX package has one (``analysis/racecheck.py``), the port
does not yet:

``@control_thread_only``
    The method runs only on the farm's control thread (lockstep's single
    host thread, or the async mode's admission/eviction loop). Attributes
    it mutates are control-owned: a mutation of the same attribute from
    an unannotated or ``@any_thread`` method is a finding — the shape of
    a ``force_evict`` race, where an any-thread test/CLI hook mutates a
    set the control plane sweeps.

``@slot_thread_only``
    The method runs only on a slot's dispatcher thread. Mixing slot- and
    control-owned mutations of one attribute is a finding.

``@any_thread``
    Explicitly callable from anywhere. Mutations of owned attributes
    inside must hold the owning lock.

``@locked("_mu")``
    The body executes with ``self._mu`` held (it acquires it, or every
    caller does). Counts the same as a ``with self._mu:`` block.

``@exclusive``
    Runs before (or outside) any concurrency — construction-time helpers
    like a ledger's ``_open``. Exempt from lock checks, like
    ``__init__``.

``@thread_confined`` (class decorator)
    Instances are owned by one thread for their whole life (the
    ``ClientDriver`` contract); the lint skips the class body.
"""


def control_thread_only(fn):
    fn.__zp_owner__ = "control"
    return fn


def slot_thread_only(fn):
    fn.__zp_owner__ = "slot"
    return fn


def any_thread(fn):
    fn.__zp_owner__ = "any"
    return fn


def exclusive(fn):
    fn.__zp_owner__ = "exclusive"
    return fn


def locked(lock_attr: str):
    def deco(fn):
        name = lock_attr[5:] if lock_attr.startswith("self.") else lock_attr
        held = set(getattr(fn, "__zp_locked__", ()))
        held.add(name)
        fn.__zp_locked__ = frozenset(held)
        return fn
    return deco


def thread_confined(cls):
    cls.__zp_confined__ = True
    return cls
