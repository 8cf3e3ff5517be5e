/* A standalone C caller of cuopt_torch's C ABI (cpp/include/cuopt_c.h).
 *
 * Builds a two-row LP with cuOptCreateProblem,
 *
 *   minimize   -0.2 x0 - 0.1 x1
 *   subject to  3.0 x0 + 4.0 x1 <= 5.4
 *               2.7 x0 + 10.1 x1 <= 4.9,   x >= 0
 *
 * (optimum -0.36 at x = (1.8, 0)), sets the method (first argument, a
 * CUOPT_METHOD value; 2, the dual simplex, by default), solves, and prints
 *
 *   status <termination status> objective <value> x0 <value> x1 <value>
 *
 * Exit code 0 when every call returned CUOPT_SUCCESS, 1 otherwise, after
 * a line naming the call and its status. The library embeds the Python
 * interpreter that runs cuopt_torch: run this program with an import path
 * that reaches the checkout and torch (kernels/build.py embed_env()).
 */
#include <math.h>
#include <stdio.h>

#include "cuopt_c.h"

#define CHECK(call)                                              \
  do {                                                           \
    cuopt_int_t st_ = (call);                                    \
    if (st_ != CUOPT_SUCCESS) {                                  \
      printf("c_api_check: %s returned %d\n", #call, (int)st_);  \
      return 1;                                                  \
    }                                                            \
  } while (0)

int main(int argc, char** argv)
{
  const char* method = argc > 1 ? argv[1] : "2";
  cuopt_float_t c[2] = {-0.2, -0.1};
  cuopt_int_t offsets[3] = {0, 2, 4};
  cuopt_int_t indices[4] = {0, 1, 0, 1};
  cuopt_float_t values[4] = {3.0, 4.0, 2.7, 10.1};
  char sense[2] = {CUOPT_LESS_THAN, CUOPT_LESS_THAN};
  cuopt_float_t rhs[2] = {5.4, 4.9};
  cuopt_float_t lb[2] = {0.0, 0.0};
  cuopt_float_t ub[2] = {INFINITY, INFINITY};
  char types[2] = {CUOPT_CONTINUOUS, CUOPT_CONTINUOUS};

  cuOptOptimizationProblem problem = NULL;
  cuOptSolverSettings settings = NULL;
  cuOptSolution solution = NULL;
  CHECK(cuOptCreateProblem(2, 2, CUOPT_MINIMIZE, 0.0, c, offsets, indices,
                           values, sense, rhs, lb, ub, types, &problem));
  cuopt_int_t n_vars = 0;
  CHECK(cuOptGetNumVariables(problem, &n_vars));
  if (n_vars != 2) {
    printf("c_api_check: %d variables, not 2\n", (int)n_vars);
    return 1;
  }
  CHECK(cuOptCreateSolverSettings(&settings));
  CHECK(cuOptSetParameter(settings, "method", method));
  CHECK(cuOptSetParameter(settings, "log_to_console", "false"));
  CHECK(cuOptSolve(problem, settings, &solution));

  cuopt_int_t status = 0;
  cuopt_float_t objective = 0.0;
  cuopt_float_t x[2] = {0.0, 0.0};
  CHECK(cuOptGetTerminationStatus(solution, &status));
  CHECK(cuOptGetObjectiveValue(solution, &objective));
  CHECK(cuOptGetPrimalSolution(solution, x));
  printf("status %d objective %.17g x0 %.17g x1 %.17g\n", (int)status,
         objective, x[0], x[1]);
  CHECK(cuOptDestroySolution(&solution));
  CHECK(cuOptDestroySolverSettings(&settings));
  CHECK(cuOptDestroyProblem(&problem));
  return 0;
}
