"""Response leaf evaluators: plain, dynamic JSON and the wristband."""

from .dynamic_json import DynamicJSON  # noqa: F401
from .plain import Plain  # noqa: F401
from .wristband import SigningKey, Wristband  # noqa: F401
