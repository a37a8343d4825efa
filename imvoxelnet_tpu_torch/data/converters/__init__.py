"""Raw dataset trees -> the info files the datasets read.

Counterparts of ``imvoxelnet_tpu/data/converters/*``: numpy on the host, the
same raw tree giving the same pickles.  ``tools/create_data.py`` runs them.
"""
