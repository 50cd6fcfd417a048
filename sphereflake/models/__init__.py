from sphereflake.models.sphereflake import child_templates, root_frame  # noqa: F401
