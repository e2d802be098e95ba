"""k1_roofline.<kind> of a serving cell: K1's share of its roofline in the
diff chunks of the traced window: the least time of each launch at its
chunk's live frames (float32 products at the TF32 peak, bytes at HBM's) over
its device time, in %. Read for every ``k1_roofline.*`` metric without a
file of its own (``k1_roofline.train`` has one: a step's launches)."""

from benchmark.readers import k1_roofline_chunks


def read(run):
    return k1_roofline_chunks(run, "diff")
