"""The data-, tensor-, sequence- and expert-parallel mesh
(``parallel/mesh.py``) and its equality check (``parallel/check.py``)."""
