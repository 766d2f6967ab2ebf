"""The work each roofline share counts: `work(ctx) -> (operations, bytes)`
per bank step, from the algorithm and the shapes, whatever implements
it. Each input byte is read once and each output byte written once."""
