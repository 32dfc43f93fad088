"""The port's C++ native oracle on the host CPU (``oracle.py``)."""
