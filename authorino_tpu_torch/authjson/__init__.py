"""Authorization-JSON data layer: the selector walk the encoder and the
expression oracle share."""

from .selector import Result, get, get_path  # noqa: F401
