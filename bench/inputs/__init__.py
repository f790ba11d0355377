"""Input kinds: how a configuration's rows (and, for training, labels) are
made from the seed.  A configuration names its kind under ``inputs.kind``;
``bench/inputs/<kind>.py`` draws it with

    draw(seed, chunk, n, d, device, labels=False) -> (x, y or None)

``x``: chunk ``chunk`` of the kind's rows, (n, d) float32 on ``device``,
drawn there from the seed's streams (``core.seeds``) in a few large calls;
``y``: their (n,) float32 labels when ``labels`` is true.  A new kind of
data is a new file here."""
