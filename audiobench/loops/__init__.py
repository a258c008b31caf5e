"""The loops a traffic mix names: ``scan`` and ``callbacks``."""
