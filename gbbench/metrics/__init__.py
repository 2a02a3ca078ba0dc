"""The metrics of gbbench, each module found by its name
(``gbbench/__init__.py``)."""
