"""Metadata leaf evaluators."""

from .generic_http import GenericHttp  # noqa: F401
from .uma import UMA  # noqa: F401
from .user_info import UserInfo  # noqa: F401
