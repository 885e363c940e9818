"""Response leaf evaluators: plain and dynamic JSON."""

from .dynamic_json import DynamicJSON  # noqa: F401
from .plain import Plain  # noqa: F401
