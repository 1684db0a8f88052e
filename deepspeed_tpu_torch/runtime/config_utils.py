"""Typed config models.

Analogue of the reference ``deepspeed/runtime/config_utils.py``
(``DeepSpeedConfigModel``): every subsystem config is a declarative class with
typed, defaulted fields, deprecated-key aliasing, and strict unknown-key
detection. Implemented on dataclass-like plain classes (no pydantic in the
image) to keep import cost near zero.
"""

import copy
import json
from ..utils.logging import logger


class ConfigField:
    """Declarative field: default + optional alias (deprecated name) + validator."""

    def __init__(self, default=None, aliases=(), validator=None, help=""):
        self.default = default
        self.aliases = tuple(aliases)
        self.validator = validator
        self.help = help


class DeepSpeedConfigModel:
    """Base class: subclasses declare ``ConfigField`` class attributes.

    ``Model(param_dict)`` consumes keys named after the attributes (or their
    aliases); unknown keys raise unless ``_allow_extra`` is set; nested models
    are declared by assigning the model *class* as a field default factory via
    ``ConfigField(default=SubModel)``.
    """

    _allow_extra = False

    def __init__(self, param_dict=None):
        param_dict = copy.copy(param_dict) if param_dict else {}
        cls = type(self)
        fields = {}
        for klass in reversed(cls.__mro__):
            for name, val in vars(klass).items():
                if isinstance(val, ConfigField):
                    fields[name] = val
        consumed = set()
        for name, field in fields.items():
            value = _MISSING
            if name in param_dict:
                value = param_dict[name]
                consumed.add(name)
            else:
                for alias in field.aliases:
                    if alias in param_dict:
                        value = param_dict[alias]
                        consumed.add(alias)
                        logger.warning(f"Config parameter {alias} is deprecated, use {name} instead")
                        break
            default = field.default
            if not isinstance(default, type) and callable(default) and value is _MISSING:
                # factory default (lambda producing a fresh mutable value)
                value = default()
            if isinstance(default, type) and not issubclass(default, DeepSpeedConfigModel):
                # factory default (dict/list/…): instantiate when absent
                if value is _MISSING:
                    value = default()
            if isinstance(default, type) and issubclass(default, DeepSpeedConfigModel):
                # nested model
                sub_dict = value if value is not _MISSING else {}
                if isinstance(sub_dict, DeepSpeedConfigModel):
                    value = sub_dict
                elif isinstance(sub_dict, bool):
                    # patterns like "bf16": true are not valid for nested models
                    raise ValueError(f"Expected dict for config key '{name}', got {sub_dict!r}")
                else:
                    value = default(sub_dict or {})
            elif value is _MISSING:
                value = copy.deepcopy(default)
            if field.validator is not None and value is not None:
                value = field.validator(value)
            setattr(self, name, value)
        extra = set(param_dict) - consumed
        if extra and not self._allow_extra:
            raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(extra)}")
        self._extra = {k: param_dict[k] for k in extra}

    def to_dict(self):
        out = {}
        for name in vars(self):
            if name.startswith("_"):
                continue
            val = getattr(self, name)
            if isinstance(val, DeepSpeedConfigModel):
                val = val.to_dict()
            out[name] = val
        out.update(getattr(self, "_extra", {}))
        return out

    def __repr__(self):
        return f"{type(self).__name__}({json.dumps(self.to_dict(), default=str)})"


class _Missing:

    def __repr__(self):
        return "<MISSING>"


_MISSING = _Missing()


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing JSON (reference behavior)."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, v in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d
