from satnerf_tpu_torch.utils.sort import (
    sort_by_acquisition_date,
    sort_by_day_of_the_year,
    sort_by_increasing_solar_incidence_angle,
    sort_by_increasing_view_incidence_angle,
)

__all__ = [
    "sort_by_acquisition_date",
    "sort_by_day_of_the_year",
    "sort_by_increasing_solar_incidence_angle",
    "sort_by_increasing_view_incidence_angle",
]
