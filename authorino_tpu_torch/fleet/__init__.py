"""Fleet planes.

Only the verdict-cache warm-join is here (``warmjoin``: the hot-set digest
a joining replica or a warm restart imports).  The router, the fold
aggregator, the replica harness and the fleet canary come with ROADMAP
queue 1 item 13."""

from .warmjoin import HOTSET_VERSION, export_hotset, import_hotset

__all__ = ["export_hotset", "import_hotset", "HOTSET_VERSION"]
