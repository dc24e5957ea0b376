"""ZP-Cert of the port: static board certification + farm control-plane
race lint.

Two independent passes over the things the farm trusts implicitly:

* :mod:`repro_torch.analysis.boardcheck` — certify a DUT engine by one call
  on FAKE tensors (``FakeTensorMode``: no storage, no device dispatch) and
  read the trace for the hazard classes behind the farm's bugs (host syncs
  in window bodies, in-place writes of the shell or stack, in-place state
  updates with no replay copy, carry drift, RNG streams reused or shared,
  fused scope planes over in-place engines). Rule IDs ``ZC1xx``.
* :mod:`repro_torch.analysis.racecheck` — an AST lock-discipline lint over
  the farm control plane: ownership is declared with the lightweight
  decorators in :mod:`repro_torch.analysis.annotations`
  (``@control_thread_only``, ``@locked("_mu")``, ...) and every
  shared-attribute mutation outside its lock or owner thread is a
  finding. Rule IDs ``RC2xx``.

``python -m repro_torch.analysis`` runs both passes (the ZP-Cert gate);
``FarmManager(certify=True)`` runs boardcheck at job admission and
dead-letters uncertifiable boards with a journaled ``certify_fail``
record.
"""
from repro_torch.analysis.annotations import (any_thread,
                                              control_thread_only,
                                              exclusive, locked,
                                              slot_thread_only,
                                              thread_confined)
from repro_torch.analysis.boardcheck import (CertReport, Finding, RULES,
                                             certify_engine, certify_job,
                                             certify_spec, job_trees,
                                             no_dispatch_guard,
                                             warm_fake_device)
from repro_torch.analysis.racecheck import (RaceFinding, check_paths,
                                            check_source, farm_sources)

__all__ = [
    "CertReport", "Finding", "RULES", "certify_engine", "certify_job",
    "certify_spec", "job_trees", "no_dispatch_guard", "warm_fake_device",
    "RaceFinding", "check_paths", "check_source", "farm_sources",
    "any_thread", "control_thread_only", "exclusive", "locked",
    "slot_thread_only", "thread_confined",
]
