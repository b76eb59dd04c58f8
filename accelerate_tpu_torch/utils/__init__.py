from .environment import (
    get_int_from_env,
    get_str_from_env,
    parse_flag_from_env,
    resolve_device,
    str_to_bool,
)

__all__ = [
    "get_int_from_env",
    "get_str_from_env",
    "parse_flag_from_env",
    "resolve_device",
    "str_to_bool",
]
