"""Typed-config base class with deprecated-field migration.

Copy of ``deepspeed_tpu/runtime/config_utils.py``'s ``DeepSpeedConfigModel``
(pydantic v2, with the ``Field(deprecated=True, new_param=...)`` migration
machinery) and its ``json.load`` hook that refuses duplicate keys, with
the port's own logger.

Deprecated fields are declared via ``json_schema_extra``::

    my_old_field: int = Field(0, json_schema_extra={
        "deprecated": True,
        "new_param": "my_new_field",   # dotted path OK
        "new_param_fn": lambda x: x,   # value translation
    })
"""

from pydantic import BaseModel, ConfigDict, model_validator

from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigModel(BaseModel):
    """Base for all config sub-models: unknown keys rejected, deprecation handled."""

    model_config = ConfigDict(
        extra="forbid",
        validate_default=True,
        validate_assignment=True,
        use_enum_values=True,
        populate_by_name=True,
        arbitrary_types_allowed=True,
    )

    def __init__(self, strict=False, **data):
        if not strict:  # "auto" values fall back to field defaults (reference behavior)
            data = {k: v for k, v in data.items() if (v != "auto" or k == "replace_method")}
        super().__init__(**data)

    @model_validator(mode="after")
    def _migrate_deprecated(self):
        fields = type(self).model_fields
        for name, field in fields.items():
            extra = field.json_schema_extra or {}
            if not isinstance(extra, dict) or not extra.get("deprecated"):
                continue
            if name not in (self.model_fields_set or ()):
                continue
            new_param = extra.get("new_param", "")
            logger.warning(
                f"Config parameter {name} is deprecated"
                + (f" use {new_param} instead" if new_param else "")
            )
            if new_param and extra.get("set_new_param", True):
                # Don't overwrite an explicitly-set new param.
                fn = extra.get("new_param_fn", lambda x: x)
                value = fn(getattr(self, name))
                parts = new_param.split(".")
                target = self
                for p in parts[:-1]:
                    target = getattr(target, p)
                if parts[-1] not in (target.model_fields_set or ()):
                    # object.__setattr__: plain setattr would re-enter this
                    # validator via validate_assignment.
                    object.__setattr__(target, parts[-1], value)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __getitem__(self, key):
        return getattr(self, key)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``json.load`` hook refusing duplicate keys, as the JAX config's."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counts = {}
        for k, _ in ordered_pairs:
            counts[k] = counts.get(k, 0) + 1
        keys = [k for k, n in counts.items() if n > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
