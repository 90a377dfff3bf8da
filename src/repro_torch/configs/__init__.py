"""Architecture configs of the LM substrate (copies of ``repro.configs``):
``base`` holds the schema, each other module one ``CONFIG``."""
