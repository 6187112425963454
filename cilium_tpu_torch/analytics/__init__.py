"""Device-resident traffic analytics, ported from ``cilium_tpu/analytics``:
count-min heavy-hitter sketches, candidate key tables and distinct-flow
cardinality registers fused into the serving steps (``stage``, torch),
with the bit-exact numpy twin (``oracle``) and the host top-K decoder
(``decode``), both numpy copies."""
