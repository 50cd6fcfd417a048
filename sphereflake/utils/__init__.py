from sphereflake.utils.image import write_png  # noqa: F401
