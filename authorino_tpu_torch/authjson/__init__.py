"""Authorization-JSON data layer: selectors, values/templates, well-known
attributes."""

from .selector import Result, get, get_path  # noqa: F401
from .value import (  # noqa: F401
    JSONProperty,
    JSONValue,
    is_template,
    replace_placeholders,
    stringify_json,
)
from .wellknown import (  # noqa: F401
    CheckRequestModel,
    HttpRequestAttributes,
    PeerAttributes,
    build_authorization_json,
)
