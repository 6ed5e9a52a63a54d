"""Typed config-model base (counterpart of
``deepspeed_tpu/runtime/config_utils.py``; reference: runtime/config_utils.py:16
``DeepSpeedConfigModel`` on pydantic).

A dependency-light base over dataclasses: declarative fields, type coercion
of the values read from a JSON/dict config, and a warning for unknown keys.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, TypeVar, get_args, get_origin

from deepspeed_tpu_torch.utils.logging import logger

T = TypeVar("T", bound="DeepSpeedConfigModel")


def _coerce(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if value is None:
        return None
    if origin is not None:
        args = get_args(typ)
        if origin is dict or origin is list or origin is tuple:
            return value
        # Optional[X] / Union
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except Exception:
                continue
        return value
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return typ.from_dict(value)
    if typ in (int, float, str, bool) and not isinstance(value, typ):
        if typ is bool and isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "on")
        if typ is int and isinstance(value, str) and value.lower() == "auto":
            return value  # "auto" survives as sentinel
        try:
            return typ(value)
        except (TypeError, ValueError):
            return value
    return value


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base for all subsystem configs. Construct with ``from_dict``."""

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]] = None) -> T:
        data = dict(data or {})
        names = {f.name for f in dataclasses.fields(cls)}
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = {}
        kwargs: Dict[str, Any] = {}
        for key, value in data.items():
            if key not in names:
                logger.warning(f"{cls.__name__}: unknown config key '{key}' ignored")
                continue
            kwargs[key] = _coerce(value, hints.get(key, Any))
        obj = cls(**kwargs)
        obj._validate()
        return obj

    def _validate(self) -> None:  # override in subclasses
        pass
