"""The tile layer's codecs. Only the KTB2 integer-stream encoder
(:mod:`kart_tpu_torch.tiles.streams`) is ported: the sidecar's vertex
column is written with it. Tile serving and export are not ported."""
