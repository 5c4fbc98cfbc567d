"""Distributed helpers of the port.  So far only the int8 column encoding
of ``compression`` (the compressed layout quantizes its confidence and
lift columns with it); the sharded engine is ROADMAP slice 6."""
