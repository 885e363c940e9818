"""Serving runtime: the micro-batching engine.

``EngineEntry`` and ``PolicyEngine`` load with ``runtime.engine`` at their
first use, so a module that needs only a light runtime module (the fleet's
router and aggregator read ``change_safety``) imports no evaluator."""

__all__ = ["EngineEntry", "PolicyEngine"]


def __getattr__(name):
    if name in ("EngineEntry", "PolicyEngine", "engine"):
        import importlib

        engine = importlib.import_module(f"{__name__}.engine")
        return engine if name == "engine" else getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
