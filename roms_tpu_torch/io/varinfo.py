"""Output variable metadata registry.

The analog of the reference's ROMS/External/varinfo.yaml (620 entries) +
mod_ncparam.F field IDs: every output field carries CF-style metadata.
Only fields the framework currently produces are registered; the registry
is data, extend freely.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class VarInfo:
    name: str
    long_name: str
    units: str
    grid: str          # r2, u2, v2, r3, w3 (rho/u/v points, 2D/3D)
    time: bool = True


REGISTRY = {
    "zeta": VarInfo("zeta", "free-surface", "meter", "r2"),
    "ubar": VarInfo("ubar", "vertically integrated u-momentum component",
                    "meter second-1", "u2"),
    "vbar": VarInfo("vbar", "vertically integrated v-momentum component",
                    "meter second-1", "v2"),
    "u": VarInfo("u", "u-momentum component", "meter second-1", "r3"),
    "v": VarInfo("v", "v-momentum component", "meter second-1", "r3"),
    "temp": VarInfo("temp", "potential temperature", "Celsius", "r3"),
    "salt": VarInfo("salt", "salinity", "nondimensional", "r3"),
    "AKv": VarInfo("AKv", "vertical viscosity coefficient",
                   "meter2 second-1", "w3"),
    "hsbl": VarInfo("hsbl", "depth of oceanic surface boundary layer",
                    "meter", "r2"),
    # static grid variables
    "h": VarInfo("h", "bathymetry at RHO-points", "meter", "r2",
                 time=False),
    "f": VarInfo("f", "Coriolis parameter at RHO-points", "second-1",
                 "r2", time=False),
    "pm": VarInfo("pm", "curvilinear coordinate metric in XI", "meter-1",
                  "r2", time=False),
    "pn": VarInfo("pn", "curvilinear coordinate metric in ETA", "meter-1",
                  "r2", time=False),
    "x_rho": VarInfo("x_rho", "x-locations of RHO-points", "meter", "r2",
                     time=False),
    "y_rho": VarInfo("y_rho", "y-locations of RHO-points", "meter", "r2",
                     time=False),
    "Cs_r": VarInfo("Cs_r", "S-coordinate stretching curves at RHO-points",
                    "nondimensional", "sr", time=False),
    "Cs_w": VarInfo("Cs_w", "S-coordinate stretching curves at W-points",
                    "nondimensional", "sw", time=False),
    # biological tracers (varinfo.yaml NPZD entries)
    "NO3": VarInfo("NO3", "nitrate concentration", "millimole_NO3 meter-3",
                   "r3"),
    "phytoplankton": VarInfo("phytoplankton", "phytoplankton concentration",
                             "millimole_N meter-3", "r3"),
    "zooplankton": VarInfo("zooplankton", "zooplankton concentration",
                           "millimole_N meter-3", "r3"),
    "detritus": VarInfo("detritus", "detritus concentration",
                        "millimole_N meter-3", "r3"),
    # additional standard output fields (varinfo.yaml entries)
    "AKt": VarInfo("AKt", "temperature vertical diffusion coefficient",
                   "meter2 second-1", "w3"),
    "AKs": VarInfo("AKs", "salinity vertical diffusion coefficient",
                   "meter2 second-1", "w3"),
    "tke": VarInfo("tke", "turbulent kinetic energy",
                   "meter2 second-2", "w3"),
    "gls": VarInfo("gls", "turbulent generic length-scale",
                   "meter3 second-2", "w3"),
    "Lscale": VarInfo("Lscale", "turbulent length scale", "meter", "w3"),
    "hbbl": VarInfo("hbbl", "depth of oceanic bottom boundary layer",
                    "meter", "r2"),
    "w": VarInfo("w", "vertical momentum component", "meter second-1",
                 "w3"),
    "omega": VarInfo("omega", "S-coordinate vertical momentum component",
                     "meter3 second-1", "w3"),
    "rho": VarInfo("rho", "density anomaly", "kilogram meter-3", "r3"),
    # quadratic / derived time-average fields (set_avg.F:2352-3952)
    "zeta2": VarInfo("zeta2", "time-averaged squared free-surface",
                     "meter2", "r2"),
    "ubar2": VarInfo("ubar2", "time-averaged squared vertically "
                     "integrated u-momentum", "meter2 second-2", "u2"),
    "vbar2": VarInfo("vbar2", "time-averaged squared vertically "
                     "integrated v-momentum", "meter2 second-2", "v2"),
    "uu": VarInfo("uu", "time-averaged squared u-momentum",
                  "meter2 second-2", "r3"),
    "vv": VarInfo("vv", "time-averaged squared v-momentum",
                  "meter2 second-2", "r3"),
    "uv": VarInfo("uv", "time-averaged u-momentum times v-momentum",
                  "meter2 second-2", "r3"),
    "Huon": VarInfo("Huon", "time-averaged u-momentum flux, Huon",
                    "meter3 second-1", "r3"),
    "Hvom": VarInfo("Hvom", "time-averaged v-momentum flux, Hvom",
                    "meter3 second-1", "r3"),
    "sustr": VarInfo("sustr", "surface u-momentum stress",
                     "newton meter-2", "u2"),
    "svstr": VarInfo("svstr", "surface v-momentum stress",
                     "newton meter-2", "v2"),
    "bustr": VarInfo("bustr", "bottom u-momentum stress",
                     "newton meter-2", "u2"),
    "bvstr": VarInfo("bvstr", "bottom v-momentum stress",
                     "newton meter-2", "v2"),
    "shflux": VarInfo("shflux", "surface net heat flux", "watt meter-2",
                      "r2"),
    "ssflux": VarInfo("ssflux", "surface net salt flux",
                      "meter second-1", "r2"),
    "swrad": VarInfo("swrad", "solar shortwave radiation flux",
                     "watt meter-2", "r2"),
    "lon_rho": VarInfo("lon_rho", "longitude of RHO-points", "degree_east",
                       "r2", time=False),
    "lat_rho": VarInfo("lat_rho", "latitude of RHO-points", "degree_north",
                       "r2", time=False),
    "angle": VarInfo("angle", "angle between XI-axis and EAST", "radians",
                     "r2", time=False),
    "mask_rho": VarInfo("mask_rho", "mask on RHO-points", "nondimensional",
                        "r2", time=False),
    "rheight": VarInfo("rheight", "bed ripple height", "meter", "r2"),
    "rlength": VarInfo("rlength", "bed ripple length", "meter", "r2"),
    # fast-time-averaged 2-D fields (mod_coupling.F; averaged output
    # parity with set_avg.F idU2av/idV2av entries)
    "DU_avg1": VarInfo("DU_avg1", "time-averaged u-transport",
                       "meter3 second-1", "u2"),
    "DV_avg1": VarInfo("DV_avg1", "time-averaged v-transport",
                       "meter3 second-1", "v2"),
    # surface quick-save fields (wrt_quick.F idSur* entries)
    "temp_sur": VarInfo("temp_sur", "surface potential temperature",
                        "Celsius", "r2"),
    "salt_sur": VarInfo("salt_sur", "surface salinity",
                        "nondimensional", "r2"),
    "u_sur": VarInfo("u_sur", "surface u-momentum component",
                     "meter second-1", "u2"),
    "v_sur": VarInfo("v_sur", "surface v-momentum component",
                     "meter second-1", "v2"),
}

# --- additional registry entries (varinfo.yaml parity for the fields
# this framework computes or accepts; grouped as in the reference) ---
REGISTRY.update({
    # grid/static (get_grid.F variable set)
    "lon_u": VarInfo("lon_u", "longitude of U-points", "degree_east",
                     "u2", time=False),
    "lat_u": VarInfo("lat_u", "latitude of U-points", "degree_north",
                     "u2", time=False),
    "lon_v": VarInfo("lon_v", "longitude of V-points", "degree_east",
                     "v2", time=False),
    "lat_v": VarInfo("lat_v", "latitude of V-points", "degree_north",
                     "v2", time=False),
    "mask_u": VarInfo("mask_u", "mask on U-points", "nondimensional",
                      "u2", time=False),
    "mask_v": VarInfo("mask_v", "mask on V-points", "nondimensional",
                      "v2", time=False),
    "mask_psi": VarInfo("mask_psi", "mask on psi-points",
                        "nondimensional", "r2", time=False),
    "s_rho": VarInfo("s_rho", "S-coordinate at RHO-points",
                     "nondimensional", "sr", time=False),
    "s_w": VarInfo("s_w", "S-coordinate at W-points", "nondimensional",
                   "sw", time=False),
    "hc": VarInfo("hc", "S-coordinate critical depth", "meter", "r2",
                  time=False),
    "Tcline": VarInfo("Tcline", "S-coordinate surface/bottom layer "
                      "width", "meter", "r2", time=False),
    "theta_s": VarInfo("theta_s", "S-coordinate surface control "
                       "parameter", "nondimensional", "r2", time=False),
    "theta_b": VarInfo("theta_b", "S-coordinate bottom control "
                       "parameter", "nondimensional", "r2", time=False),
    # free surface / momentum time means & detided (set_avg.F)
    "zeta_avg": VarInfo("zeta_avg", "time-averaged free-surface",
                        "meter", "r2"),
    "DU_avg2": VarInfo("DU_avg2", "time-averaged u-transport for 3D "
                       "advection", "meter3 second-1", "u2"),
    "DV_avg2": VarInfo("DV_avg2", "time-averaged v-transport for 3D "
                       "advection", "meter3 second-1", "v2"),
    # surface forcing fields (mod_forces / frc files)
    "Uwind": VarInfo("Uwind", "surface u-wind component",
                     "meter second-1", "r2"),
    "Vwind": VarInfo("Vwind", "surface v-wind component",
                     "meter second-1", "r2"),
    "Tair": VarInfo("Tair", "surface air temperature", "Celsius", "r2"),
    "Pair": VarInfo("Pair", "surface air pressure", "millibar", "r2"),
    "Qair": VarInfo("Qair", "surface air relative humidity",
                    "percentage", "r2"),
    "rain": VarInfo("rain", "rain fall rate",
                    "kilogram meter-2 second-1", "r2"),
    "cloud": VarInfo("cloud", "cloud fraction", "nondimensional", "r2"),
    "lhflx": VarInfo("lhflx", "latent heat flux", "watt meter-2", "r2"),
    "shflx": VarInfo("shflx", "sensible heat flux", "watt meter-2",
                     "r2"),
    "lrflx": VarInfo("lrflx", "net longwave radiation flux",
                     "watt meter-2", "r2"),
    "EminusP": VarInfo("EminusP", "bulk evaporation minus "
                       "precipitation", "meter second-1", "r2"),
    "evaporation": VarInfo("evaporation", "evaporation rate",
                           "kilogram meter-2 second-1", "r2"),
    # wave fields (nearshore / bbl forcing)
    "Hwave": VarInfo("Hwave", "wind-induced significant wave height",
                     "meter", "r2"),
    "Dwave": VarInfo("Dwave", "wind-induced wave direction", "radians",
                     "r2"),
    "Lwave": VarInfo("Lwave", "wind-induced wave length", "meter",
                     "r2"),
    "Pwave_top": VarInfo("Pwave_top", "wind-induced surface wave "
                         "period", "second", "r2"),
    # radiation stresses / Stokes drift (nearshore_mellor05 outputs)
    "Sxx": VarInfo("Sxx", "radiation stress, Sxx component",
                   "meter3 second-2", "r3"),
    "Sxy": VarInfo("Sxy", "radiation stress, Sxy component",
                   "meter3 second-2", "r3"),
    "Syy": VarInfo("Syy", "radiation stress, Syy component",
                   "meter3 second-2", "r3"),
    "u_stokes": VarInfo("u_stokes", "u-Stokes drift velocity",
                        "meter second-1", "r3"),
    "v_stokes": VarInfo("v_stokes", "v-Stokes drift velocity",
                        "meter second-1", "r3"),
    "ubar_stokes": VarInfo("ubar_stokes", "vertically averaged "
                           "u-Stokes drift", "meter second-1", "u2"),
    "vbar_stokes": VarInfo("vbar_stokes", "vertically averaged "
                           "v-Stokes drift", "meter second-1", "v2"),
    # mixing / turbulence closure outputs (mod_mixing)
    "AKk": VarInfo("AKk", "TKE vertical diffusion coefficient",
                   "meter2 second-1", "w3"),
    "AKp": VarInfo("AKp", "length-scale vertical diffusion "
                   "coefficient", "meter2 second-1", "w3"),
    "ghats": VarInfo("ghats", "KPP nonlocal transport",
                     "meter second-2", "w3"),
    # BBL outputs (mod_sedbed / bbl.F)
    "Zo_def": VarInfo("Zo_def", "default bottom roughness", "meter",
                      "r2"),
    "Zo_app": VarInfo("Zo_app", "apparent bottom roughness", "meter",
                      "r2"),
    "bustrc": VarInfo("bustrc", "bottom u-current stress",
                      "newton meter-2", "u2"),
    "bvstrc": VarInfo("bvstrc", "bottom v-current stress",
                      "newton meter-2", "v2"),
    "bustrw": VarInfo("bustrw", "bottom u-wave stress",
                      "newton meter-2", "u2"),
    "bvstrw": VarInfo("bvstrw", "bottom v-wave stress",
                      "newton meter-2", "v2"),
    "bustrcwmax": VarInfo("bustrcwmax", "bottom u-max wave-current "
                          "stress", "newton meter-2", "u2"),
    "bvstrcwmax": VarInfo("bvstrcwmax", "bottom v-max wave-current "
                          "stress", "newton meter-2", "v2"),
    # sediment (mod_sedbed)
    "bed_thickness": VarInfo("bed_thickness", "sediment bed layer "
                             "thickness", "meter", "r2"),
    "bed_porosity": VarInfo("bed_porosity", "sediment bed layer "
                            "porosity", "nondimensional", "r2"),
    "ripple_height": VarInfo("ripple_height", "bed ripple height",
                             "meter", "r2"),
    "ripple_length": VarInfo("ripple_length", "bed ripple length",
                             "meter", "r2"),
    # tides (mod_tides)
    "tide_period": VarInfo("tide_period", "tide angular period",
                           "hours", "r2", time=False),
    "tide_Eamp": VarInfo("tide_Eamp", "tidal elevation amplitude",
                         "meter", "r2", time=False),
    "tide_Ephase": VarInfo("tide_Ephase", "tidal elevation phase "
                           "angle", "degrees", "r2", time=False),
    # 4D-Var / observations (s4dvar obs files)
    "obs_value": VarInfo("obs_value", "observation value",
                         "state variable units", "r2"),
    "obs_error": VarInfo("obs_error", "observation error covariance",
                         "squared state variable units", "r2"),
    "obs_time": VarInfo("obs_time", "time of observation", "seconds",
                        "r2"),
    "obs_Xgrid": VarInfo("obs_Xgrid", "x-grid observation location",
                         "nondimensional", "r2"),
    "obs_Ygrid": VarInfo("obs_Ygrid", "y-grid observation location",
                         "nondimensional", "r2"),
    "obs_Zgrid": VarInfo("obs_Zgrid", "z-grid observation location",
                         "nondimensional", "r2"),
    # station / floats streams
    "Xgrid": VarInfo("Xgrid", "x-grid floats locations",
                     "nondimensional", "r2"),
    "Ygrid": VarInfo("Ygrid", "y-grid floats locations",
                     "nondimensional", "r2"),
    "Zgrid": VarInfo("Zgrid", "z-grid floats locations",
                     "nondimensional", "r2"),
    # river/point sources (mod_sources)
    # ---- budget-diagnostics stream terms (mod_ncparam idDtrc/idDu2d
    #      families; written by io/netcdf.DiagWriter) ----
    "temp_xadv": VarInfo("temp_xadv", "potential temperature horizontal "
                         "xi-advection diagnostic", "Celsius second-1",
                         "r3"),
    "temp_yadv": VarInfo("temp_yadv", "potential temperature horizontal "
                         "eta-advection diagnostic", "Celsius second-1",
                         "r3"),
    "temp_vadv": VarInfo("temp_vadv", "potential temperature vertical "
                         "advection diagnostic", "Celsius second-1",
                         "r3"),
    "temp_vdiff": VarInfo("temp_vdiff", "potential temperature vertical "
                          "diffusion diagnostic", "Celsius second-1",
                          "r3"),
    "temp_hdiff": VarInfo("temp_hdiff", "potential temperature "
                          "horizontal diffusion diagnostic",
                          "Celsius second-1", "r3"),
    "temp_rate": VarInfo("temp_rate", "potential temperature time rate "
                         "of change", "Celsius second-1", "r3"),
    "salt_xadv": VarInfo("salt_xadv", "salinity horizontal xi-advection "
                         "diagnostic", "second-1", "r3"),
    "salt_yadv": VarInfo("salt_yadv", "salinity horizontal eta-advection "
                         "diagnostic", "second-1", "r3"),
    "salt_vadv": VarInfo("salt_vadv", "salinity vertical advection "
                         "diagnostic", "second-1", "r3"),
    "salt_vdiff": VarInfo("salt_vdiff", "salinity vertical diffusion "
                          "diagnostic", "second-1", "r3"),
    "salt_hdiff": VarInfo("salt_hdiff", "salinity horizontal diffusion "
                          "diagnostic", "second-1", "r3"),
    "salt_rate": VarInfo("salt_rate", "salinity time rate of change",
                         "second-1", "r3"),
    "u_prestep": VarInfo("u_prestep", "u-momentum predictor-step "
                         "diagnostic", "meter second-2", "r3"),
    "v_prestep": VarInfo("v_prestep", "v-momentum predictor-step "
                         "diagnostic", "meter second-2", "r3"),
    "u_prsgrd": VarInfo("u_prsgrd", "u-momentum pressure gradient "
                        "diagnostic", "meter second-2", "r3"),
    "v_prsgrd": VarInfo("v_prsgrd", "v-momentum pressure gradient "
                        "diagnostic", "meter second-2", "r3"),
    "u_cor": VarInfo("u_cor", "u-momentum Coriolis diagnostic",
                     "meter second-2", "r3"),
    "v_cor": VarInfo("v_cor", "v-momentum Coriolis diagnostic",
                     "meter second-2", "r3"),
    "u_xadv": VarInfo("u_xadv", "u-momentum horizontal xi-advection "
                      "diagnostic", "meter second-2", "r3"),
    "v_xadv": VarInfo("v_xadv", "v-momentum horizontal xi-advection "
                      "diagnostic", "meter second-2", "r3"),
    "u_yadv": VarInfo("u_yadv", "u-momentum horizontal eta-advection "
                      "diagnostic", "meter second-2", "r3"),
    "v_yadv": VarInfo("v_yadv", "v-momentum horizontal eta-advection "
                      "diagnostic", "meter second-2", "r3"),
    "u_vadv": VarInfo("u_vadv", "u-momentum vertical advection "
                      "diagnostic", "meter second-2", "r3"),
    "v_vadv": VarInfo("v_vadv", "v-momentum vertical advection "
                      "diagnostic", "meter second-2", "r3"),
    "u_hvisc": VarInfo("u_hvisc", "u-momentum horizontal viscosity "
                       "diagnostic", "meter second-2", "r3"),
    "v_hvisc": VarInfo("v_hvisc", "v-momentum horizontal viscosity "
                       "diagnostic", "meter second-2", "r3"),
    "u_vvisc": VarInfo("u_vvisc", "u-momentum vertical viscosity "
                       "diagnostic", "meter second-2", "r3"),
    "v_vvisc": VarInfo("v_vvisc", "v-momentum vertical viscosity "
                       "diagnostic", "meter second-2", "r3"),
    "u_rate": VarInfo("u_rate", "u-momentum time rate of change",
                      "meter second-2", "r3"),
    "v_rate": VarInfo("v_rate", "v-momentum time rate of change",
                      "meter second-2", "r3"),
    # ---- extended biology tracer names (fennel.h / npzd*.h /
    #      ecosim.h / nemuro.h / hypoxia_srm.h state) ----
    "NH4": VarInfo("NH4", "ammonium concentration",
                   "millimole_nitrogen meter-3", "r3"),
    "chlorophyll": VarInfo("chlorophyll", "chlorophyll concentration",
                           "milligrams_chlorophyll meter-3", "r3"),
    "oxygen": VarInfo("oxygen", "dissolved oxygen concentration",
                      "millimole_oxygen meter-3", "r3"),
    "TIC": VarInfo("TIC", "total inorganic carbon",
                   "millimole_carbon meter-3", "r3"),
    "alkalinity": VarInfo("alkalinity", "total alkalinity",
                          "milliequivalents meter-3", "r3"),
    "LdetritusN": VarInfo("LdetritusN", "large fraction nitrogen "
                          "detritus concentration",
                          "millimole_nitrogen meter-3", "r3"),
    "SdetritusN": VarInfo("SdetritusN", "small fraction nitrogen "
                          "detritus concentration",
                          "millimole_nitrogen meter-3", "r3"),
    "PO4": VarInfo("PO4", "phosphate concentration",
                   "millimole_phosphorus meter-3", "r3"),
    "opal": VarInfo("opal", "particulate organic silica concentration",
                    "millimole_silica meter-3", "r3"),
    "SiOH4": VarInfo("SiOH4", "silicate concentration",
                     "millimole_silica meter-3", "r3"),
    # ---- sediment per-class state (sediment_mod.h idsand/idmud) ----
    "sand_01": VarInfo("sand_01", "suspended noncohesive sediment, "
                       "size class 01", "kilogram meter-3", "r3"),
    "mud_01": VarInfo("mud_01", "suspended cohesive sediment, size "
                      "class 01", "kilogram meter-3", "r3"),
    "sandfrac_01": VarInfo("sandfrac_01", "noncohesive sediment "
                           "fraction, size class 01", "nondimensional",
                           "r2"),
    "bed_age": VarInfo("bed_age", "sediment layer age", "seconds",
                       "r2"),
    "bed_biodiff": VarInfo("bed_biodiff", "biodiffusivity at the "
                           "bottom of each layer", "meter2 second-1",
                           "r2"),
    "bedload_Usand_01": VarInfo("bedload_Usand_01", "bed load flux of "
                                "sand in xi-direction, class 01",
                                "kilogram meter-1 second-1", "u2"),
    "bedload_Vsand_01": VarInfo("bedload_Vsand_01", "bed load flux of "
                                "sand in eta-direction, class 01",
                                "kilogram meter-1 second-1", "v2"),
    # ---- grid / domain extras (grid NetCDF variables) ----
    "zice": VarInfo("zice", "ice shelf draft", "meter", "r2"),
    "dndx": VarInfo("dndx", "xi-derivative of inverse metric factor "
                    "pn", "meter", "r2"),
    "dmde": VarInfo("dmde", "eta-derivative of inverse metric factor "
                    "pm", "meter", "r2"),
    "xl": VarInfo("xl", "basin length in the xi-direction", "meter",
                  "r2"),
    "el": VarInfo("el", "basin length in the eta-direction", "meter",
                  "r2"),
    "spherical": VarInfo("spherical", "grid type logical switch",
                         "nondimensional", "r2"),
    "visc_factor": VarInfo("visc_factor", "horizontal viscosity "
                           "sponge factor", "nondimensional", "r2"),
    "diff_factor": VarInfo("diff_factor", "horizontal diffusivity "
                           "sponge factor", "nondimensional", "r2"),
    "wetdry_mask_rho": VarInfo("wetdry_mask_rho", "wet/dry mask on "
                               "RHO-points", "nondimensional", "r2"),
    "wetdry_mask_u": VarInfo("wetdry_mask_u", "wet/dry mask on "
                             "U-points", "nondimensional", "u2"),
    "wetdry_mask_v": VarInfo("wetdry_mask_v", "wet/dry mask on "
                             "V-points", "nondimensional", "v2"),
    # ---- surface forcing extras (frc NetCDF variables) ----
    "sms_time": VarInfo("sms_time", "surface momentum stress time",
                        "days", "r2"),
    "shf_time": VarInfo("shf_time", "surface heat flux time", "days",
                        "r2"),
    "srf_time": VarInfo("srf_time", "solar shortwave radiation time",
                        "days", "r2"),
    "SST": VarInfo("SST", "sea surface temperature climatology",
                   "Celsius", "r2"),
    "dQdSST": VarInfo("dQdSST", "surface net heat flux sensitivity to "
                      "sea surface temperature",
                      "watts meter-2 Celsius-1", "r2"),
    "wvel": VarInfo("wvel", "vertical velocity", "meter second-1",
                    "w3"),
    "river_transport": VarInfo("river_transport", "river runoff "
                               "vertically integrated mass transport",
                               "meter3 second-1", "r2"),
    "river_temp": VarInfo("river_temp", "river runoff potential "
                          "temperature", "Celsius", "r2"),
    "river_salt": VarInfo("river_salt", "river runoff salinity",
                          "nondimensional", "r2"),
})

# per-tracer diagnostics variables are registered lazily by DiagWriter
# with names <tracer>_<term> / u_<term> / v_<term> using DIA_TERMS.

# diagnostics-stream metadata (wrt_diags.F / mod_diags.F budget terms);
# key suffix -> long-name fragment.  Tracer terms are written per tracer
# as <tracer>_<term>, momentum terms as u_<term>/v_<term>.
DIA_TERMS = {
    "xadv": "horizontal XI-advection",
    "yadv": "horizontal ETA-advection",
    "vadv": "vertical advection",
    "hdiff": "horizontal diffusion",
    "vdiff": "vertical diffusion",
    "rate": "time rate of change",
    "prestep": "predictor-step contribution",
    "prsgrd": "pressure gradient",
    "cor": "Coriolis",
    "hvisc": "horizontal viscosity",
    "vvisc": "vertical viscosity + coupling remainder",
}

# per-model biology output names, in cfg.ibio order (the reference's
# <model>_var.h idTvar name assignments)
_BIO_NAMES = {
    "npzd_powell": ("NO3", "phytoplankton", "zooplankton", "detritus"),
    "npzd_franks": ("NO3", "phytoplankton", "zooplankton", "detritus"),
    "npzd_iron": ("NO3", "phytoplankton", "zooplankton", "detritus",
                  "iron", "phytoplanktonFe"),
    "fennel": ("NO3", "NH4", "chlorophyll", "phytoplankton",
               "zooplankton", "LdetritusN", "SdetritusN", "PO4",
               "LdetritusC", "SdetritusC", "TIC", "alkalinity",
               "oxygen"),
    "nemuro": ("nanophytoplankton", "diatom", "microzooplankton",
               "mesozooplankton", "Pzooplankton", "NO3", "NH4", "PON",
               "DON", "SiOH4", "opal"),
    "hypoxia_srm": ("oxygen",),
    "red_tide": ("dinoflagellate",),
}

def tracer_names(cfg):
    """Output names for every tracer index (mod_ncparam idTvar analog):
    temp, salt, then the biology model's names (cfg.ibio order) or
    generic tracerN, with VarInfo entries registered on the fly."""
    names = {}
    if cfg.ntracers >= 1:
        names[0] = "temp"
    if cfg.ntracers >= 2:
        names[1] = "salt"
    bio_names = _BIO_NAMES.get(cfg.biology, ())
    bio = dict(zip(cfg.ibio, bio_names)) if cfg.biology else {}
    for i in range(2, cfg.ntracers):
        nm = bio.get(i, f"tracer{i}")
        if nm not in REGISTRY:
            long = (f"passive tracer {i}" if nm.startswith("tracer")
                    else nm + " concentration")
            REGISTRY[nm] = VarInfo(nm, long, "millimole meter-3"
                                   if not nm.startswith("tracer")
                                   else "nondimensional", "r3")
        names[i] = nm
    return names
