from sphereflake.ops import transforms  # noqa: F401
