select
    sum(l_extendedprice * l_discount) as revenue
from
    lineitem
where
    l_shipdate >= date '{DATE}'
    and l_shipdate < date '{DATE_END}'
    and l_discount between {DISCOUNT_LO} and {DISCOUNT_HI}
    and l_quantity < {QUANTITY};
