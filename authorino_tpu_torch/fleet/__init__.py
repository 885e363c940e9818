"""Fleet serving plane: N replicas as one engine.

- :mod:`.router` — consistent-hash (rendezvous, by the verdict-cache
  routing key: dedup and cache locality survive routing) / least-loaded
  hybrid router shim with per-replica health gating, deadline-aware
  spillover to the second choice, and drain awareness;
- :mod:`.aggregate` — fleet-wide folds of the SLO burn and tenant stats,
  the GLOBAL noisy-neighbor containment check (fires when every
  per-replica share is individually under threshold), and the fleet canary
  guard (one replica canaries the candidate snapshot while the fleet holds
  baseline, judged on global cohort counts through the change-safety
  guard);
- :mod:`.warmjoin` — the verdict-cache hot-set digest a leader publishes
  next to the snapshot manifest, so a cold replica joining mid-flood
  inherits the hot set instead of re-missing it;
- :mod:`.replica` / :mod:`.harness` — the in-process replica wrapper (one
  ``PolicyEngine``, on the card unless the factory says otherwise) and the
  elastic choreography harness (add/remove/crash/canary, SIGTERM-style
  drain).

Everything here is import-light: numpy and the package's own utils, with
no evaluator and no ``grpc`` import, so the cross-replica guard math loads
on images without the serving dependency set."""

from .aggregate import FleetAggregator, GlobalContainment
from .harness import FleetHarness
from .replica import InProcessReplica
from .router import FleetRouter, in_fleet_cohort, routing_key
from .warmjoin import HOTSET_VERSION, export_hotset, import_hotset

__all__ = ["FleetAggregator", "GlobalContainment", "FleetHarness",
           "FleetRouter", "InProcessReplica", "in_fleet_cohort",
           "routing_key", "export_hotset", "import_hotset", "HOTSET_VERSION"]
