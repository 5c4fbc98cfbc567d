"""Distributed helpers of the port: the int8 column encoding of
``compression`` (the compressed layout quantizes its confidence and lift
columns with it), the serve loop's ``health`` signals, and
``trie_sharding``'s ``ShardFailure``; the sharded engine is ROADMAP
slice 6."""
